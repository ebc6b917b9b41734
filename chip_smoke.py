#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
H100: builds its CUDA kernels from this checkout, holds each against its
plain PyTorch version, drives the port's paths through the user entry
points, checks the outputs against the COO oracle ``mttkrp_ref``, and
times the kernels at each path's shapes.

  [1]  card, nvcc build;  [2] kernels vs plain at toy shapes
  [3]-[6]  the main path (``build_flycoo`` -> ``engine.init`` ->
       ``engine.all_modes`` -> ``cp_als``, backend ``cuda_fused``, whose
       compact kernels are the balanced ones of ``mttkrp_balanced.cu``) at
       the paper's nell1 tensor (scale 0.1, rank 32), ``fuse_remap=False``,
       the 5-mode twitch tensor (scale 0.01), kernel times with each
       mode's work table (chunks, split partitions, longest chunk,
       partials) and the balanced kernels' two passes timed apart
  [7]  the plan-space path (``make_engine(PlanSpec(backend="cuda"),
       cache=PlanCache())``, the pre-gathered baseline, on the balanced
       work table) at nell1 scale 0.1, compact, with ``cp_als`` held to
       the torch backend and to [3]'s float64 witness, the work-table
       gate, and the kernel's two passes timed apart with each mode's
       table
  [8]  the rect schedule at nell1 scale 0.01: ``cuda_fused`` with and
       without the fused remap, and ``cuda``, on tables that list only
       each partition's alive blocks; the work-table gate on
       ``mttkrp_fused_gather``, the two passes timed apart
  [9]  ``autotune`` over backend x schedule x P x dedup at nell1 scale
       0.01, measured by the median of 5 CUDA-event rotations a spec
  [2c] the ``wkv6`` kernel against its plain version at the reference
       kernel tests' shapes, at the model's rows (BH 160, T 256) and at
       BH 161, T 4097 (no multiple of the SMs, a ragged last chunk)
  [10] RWKV-6 at the full width of ``rwkv6-3b`` (32 layers, f32 params,
       random weights from a seed): the prefill ``forward`` in bf16 at
       B 4, S 4096 (one ``wkv6`` launch a layer, timed), layer 0's kernel
       inputs held against the plain version, a float32 cross-check of
       ``forward`` against ``Engine.prefill`` (4 layers), and
       ``Engine.generate`` serving 4 requests of 16 + 32 tokens
  [2d] the ``lru_scan`` kernel against its plain version at the
       reference kernel tests' shapes (float32 and float16 inputs), a
       ragged shape and the model's rows (B 4, T 256, D 4096)
  [11] RecurrentGemma at the full width and depth of
       ``recurrentgemma-9b`` (38 layers, 26 RG-LRU + 12 local attention,
       f32 params, random weights from a seed): the prefill ``forward``
       in bf16 at B 4, S 4096 (one ``lru_scan`` launch a rec layer, the
       banded window attention), layer 0's kernel inputs held against
       the plain version, a float32 cross-check of ``forward`` against
       ``Engine.prefill`` (4 layers over the same parameter tensors), and
       ``Engine.generate`` serving 4 requests of 16 + 32 tokens
  [12] the streaming tier (``engine.stream``: pinned host layouts, a
       copy-stream chunk ring, the remap on the host): [12a] nell1 scale
       0.1 ([3]'s tensor and factors) streamed on ``cuda_fused`` and
       ``cuda`` in ~10 chunks a mode, a mutant whose uploads read the
       previous chunk's slots, ``cp_als_stream`` against [3]'s fits;
       [12b] rect nell1 scale 0.01; [12c] twitch scale 0.01 in at least
       4 chunks a mode; [12d] the paper's vast tensor (scale 0.125) through
       ``make_engine(PlanSpec(residency="auto"))`` at 1/8 of its
       resident footprint: the streamed rotation timed (uploads, kernels
       and host remap apart) beside the resident one, its peak device
       bytes against the budget model's prediction and the resident peak
  [13] resilience (``repro_torch.resilience``), after [1]-[12] are shown
       to have taken no rung: [13a] ``cp_als`` at nell1 scale 0.01 in
       child processes (``--als-child``), clean twice (is the card
       run-to-run bitwise?), SIGKILLed at sweep 3 by ``REPRO_CHAOS`` and
       resumed from its snapshots (the resumed child must load one
       snapshot, run only sweeps 3-5 and keep the snapshot's fits
       bitwise); [13b] the backend rung ``cuda_fused -> cuda`` on [3]'s
       tensor, where the card's ladder ends; [13c] the residency rung ``full ->
       stream`` on a real ``torch.cuda.OutOfMemoryError``, [12d]'s vast
       tensor under an allocator cap; [13d] the stream's chunk-budget
       halving and upload retry at nell1 0.1; [13e] the NaN guard; [13f]
       ``resilience_report`` pairing every injected fault with its answer,
       and [13]'s Chrome trace in ``chiprun_out/chip_smoke_trace13.json``
  [14] the distributed tier (``engine.dist``: a single controller drives
       every shard of a ``launch.mesh.Mesh``; here 4 shards on one card,
       so its times are not a multi-GPU speed): [14a] [3]'s nonzeros
       planned by ``build_sharded_flycoo(n_dev=4)`` and sharded on
       ``cuda:0``, one ``dist_all_modes`` rotation under each exchange
       (``permute``, ``all_gather``) held to the oracle, to the
       single-device ``cuda_fused`` rotation and, after each transition,
       to ``shard_state`` of the single-device layout (bitwise), the bytes
       copied between shards to the schedule's, then timed (rotation,
       exchange a transition, each shard's kernel against its byte
       bound); [14b] ``cp_als(mesh=)``; [14c] twitch 0.01 on 4 shards,
       the ``cuda`` backend, rect ``cuda_fused`` on 2 shards and a (2, 2)
       data x model mesh at nell1 0.01; [14d] a dropped hop must fail the
       checks; [14e] the exchange and device-loss rungs, and
       ``--dist-child`` processes killed at sweep 3 on 4 shards and
       resumed on 2 and on 1
  [15] the dense attention family and the CPD-factorized embedding (no
       port kernel on this path: attention, MLP and the embedding's
       spMTTKRP backward are PyTorch ops, as the reference's are ``jnp``
       ops): [15a] tinyllama-1.1b, olmo-1b and qwen2.5-3b at full width
       and depth (f32 params, random weights from a seed), each with the
       bf16 prefill ``forward`` at B 4, S 4096 (timed, profiled into
       matmul / softmax / other, peak memory), a float32 cross-check of
       ``forward`` against ``Engine.prefill`` on a 4-layer copy over the
       same parameter tensors, and ``Engine.generate`` serving 4 requests
       of 16 + 32 tokens; [15b] the same for tinyllama-1.1b with
       ``cpd_embedding=True`` (rank 64, 32000 -> 179 x 179 ids), then
       ``cpd_embed``'s rows against ``dense_table()[tokens]``,
       ``cpd_logits`` against ``x @ dense_table().T`` and, at the full
       batch (16,384 tokens, D 2048), ``cpd_embed``'s three gradients
       from its own backward against autograd through the naive lookup
       and a float64 recomputation, timed beside the naive autograd
  [16] training on the card (``training.make_train_step``: AdamW, the
       chunked loss, ``remat="full"`` recompute, bf16 compute over f32
       masters), each model's steps timed (host clock around synchronised
       steps), tokens/s and peak memory: [16a] tinyllama-1.1b at full
       width and depth, ``train_4k``'s S 4096 with the batch cut from 256
       to 4, 2 steps, and a float32 4-layer copy (TF32 off) stepped on
       the card and on the CPU from the same state; [16b] the same with
       the CPD embedding (rank 64), its factor gradients at the last
       batch's cotangent held to float64 as in [15b], and 15 steps of the
       smoke CPD config whose loss must fall; [16c] rwkv6-3b at full width
       and depth, B 2, 3 steps (32 ``wkv6`` forward + 32 recompute + 32
       ``wkv6_bwd`` launches a step) and one more step under
       ``torch.profiler`` (device ms in ``wkv6_bwd``, ``wkv6``, matrix
       products and the rest), then ``wkv6_bwd`` at layer 0's prefill
       shape (BH 160, T 4096) and at the training step's own (B 2: BH 80)
       against the plain backward in float64, timed; [16d]
       recurrentgemma-9b at full width on 6 layers (two cycles of rec,
       rec, local: at full depth its 9.4B f32 parameters and gradients
       alone take 75 GB), B 2, 3 steps, then ``lru_scan_bwd`` at (4,
       4096, 4096) the same way; [16e]
       ``TrainController`` preempted at step 2 of 4 and resumed from its
       checkpoint against an uninterrupted run, a checkpoint's save and
       load timed
  [17] sharded training (``repro_torch.sharding``, the sharded
       ``make_train_step``; a single controller drives shards of
       ``cuda:0``, so its times are "shards on one card"): [17a]
       tinyllama-1.1b at full width on 11 of its 22 layers on a (data 2,
       model 2) mesh (dp + fsdp, heads / MLP columns / vocabulary over
       the model axis), B 4, S 4096: one step against the single-device step from
       the same state and batch, a timed step, peak memory, one step
       under ``torch.profiler``; a float32 2-layer copy the same way, and
       the copy without the sum over the model axis after ``wo``, which
       must fail; [17b] rwkv6-3b and recurrentgemma-9b at full width on
       4 layers over (data 2, model 2) (the time mix's heads and the
       RG-LRU's channels over the model axis), against the single-device
       step, with ``wkv6`` / ``wkv6_bwd`` / ``lru_scan`` /
       ``lru_scan_bwd`` launched on each of the 4 shards, a timed step,
       peak memory and one step under ``torch.profiler``; the four
       kernels at a model shard's shapes (BH 20 x T 4096; (1, 4096,
       2048)) against their plain versions, timed; each arch's float32
       2-layer copy, and the copy without the sum after ``w_out_t`` or
       ``w_out_rec``, which must fail; [17c] the float32 state saved on
       (2, 2) and restored onto (2, 1), bitwise; [17d] ``cp_als(mesh=ctx)`` at nell1
       0.01 against ``cp_als(mesh=Mesh)``; [17e] ``pipeline_apply`` over
       4 stages and ``compressed_grad_sync`` over 4 pods of the card
  [18] the MoE family (``models/moe.py``; no port kernel on this path:
       routing, the sort-based dropping dispatch, the combine and the
       experts' batched products are PyTorch ops, as the reference's are
       ``jnp`` ops): [18a] olmoe-1b-7b at full width and depth (16
       layers, 64 experts, top-8, f32 params, random weights from a
       seed), the bf16 prefill ``forward`` at B 4, S 4096 (C 2,560 an
       expert; timed, profiled into matmul / softmax / dispatch and
       combine / other, peak memory; a second prefill's hidden state
       bitwise the first's), a float32 cross-check of
       ``forward`` against ``Engine.prefill`` on a 4-layer copy at a
       capacity factor of E / k (without drops the two paths are the
       same function), ``Engine.generate`` serving 4 requests of 16 + 32
       tokens, and a decode step's casts of the expert weights to bf16
       timed; [18b] the same for qwen3-moe-235b-a22b at full width, its
       depth cut from 94 layers to 4 (~9.95 GB of f32 a layer: 45 GB at
       4, ~935 GB at 94); [18c] olmoe on 4 layers (its 16 layers' AdamW
       state alone would take 111 GB), B 4, S 4096, AdamW, 3 timed
       steps and one profiled, and a float32 2-layer step on the card
       against the CPU's; [18d] olmoe on 2 layers over a (data 2, model
       2) mesh of ``cuda:0`` (32 experts a model shard) at a capacity
       factor of E / k against the single-device step, then timed steps
       and a profiled step at the config's own factor (1.25), the
       float32 copy and the copy without the exchange that returns the
       experts' outputs, which must fail
  [19] the other families (no port kernel on this path): [19a]
       command-r-plus-104b at full width on 4 of its 64 layers (the
       parallel block: one shared LayerNorm, attention and SwiGLU side
       by side; 1.57 B params a layer and 3.15 B in the tied embedding:
       37.8 GB of f32), the bf16 prefill at B 4, S 4096 (timed,
       profiled, peak), the float32 check over the same 4 layers,
       serving; [19b] paligemma-3b at full width and depth, the prefill
       of 256 stub image embeddings and 3,840 tokens, the float32 check
       on a 4-layer copy without image tokens (the reference's ``vlm``
       decodes causally and its engine takes no image embeddings), the
       prefix mask on a 2-layer copy against the CPU, with a causal-mask
       variant that must fail, serving; [19c] whisper-large-v3 at full
       width and depth (32 + 32 layers), the prefill with (B, S, D) stub
       frames, the float32 check (``forward(tokens, enc_embeds)``
       against ``Engine.prefill`` after ``build_cross_caches``, 4 + 4
       layers), serving over 1,536 frames (the real 1,500 are refused,
       as the reference's chunk loop refuses them); [19d] the int8 KV
       cache on command-r's tensors: a float32 1-layer copy's int8
       engine against its float engine, every row and scale written,
       the logits, a variant that reads the rows without their scales
       (which must fail), int8 serving at 4 layers in bf16, the cache
       bytes; [19e] two training steps of each at a depth that fits
       (command-r on 1 layer under Adafactor: AdamW's state would not
       fit even at 1; paligemma full; whisper on 8 + 8 layers, cut for
       the script's time), each float32 copy's
       step on the card against the CPU's, and the sharded pair:
       command-r (at a width cut to fit the pair: d 3072, 24 / 2 heads,
       d_ff 8448, vocab 32,000) and paligemma (2 layers) over (data 2,
       model 2) with the copy that drops the sum after ``wo`` failing,
       whisper (2 + 2 layers) over (data 2, model 2) with the copy that
       drops the sum after the cross-attention's ``wo`` failing
  [20] the dry-run's counts against the card (``analysis.cost``,
       ``analysis.roofline``; ``launch.dryrun`` traces every cell of the
       production mesh this way on the host): three calls the script
       runs, [10]'s rwkv6-3b prefill (B 4, S 4096, 32 ``wkv6`` launches),
       [15a]'s tinyllama-1.1b prefill and one [16a] tinyllama-1.1b AdamW
       step, each traced on ``meta`` as a one-position cell and run on the
       card: FLOPs, temporaries and the roofline bound against the
       card's ``FlopCounterMode`` count, ``max_memory_allocated`` and
       CUDA-event time
  [21] ``all_modes`` as one CUDA graph replay (run after [7], on [3]'s
       nell1 0.1 tensor and factors) on ``cuda_fused`` and ``cuda``: the
       replay against ``N`` eager ``mttkrp`` calls, ms a rotation and an
       ALS sweep (the rotation with the fold inside the graph), graph
       and eager, and ``cp_als`` through the graph against the eager
       loop
  Serving ([10], [11], [15a], [18a], [18b], [19a]-[19d]) runs the graph
       ``Engine`` (one captured ``decode_step`` replayed, bf16 working
       copies), times it against the eager engine on the float32 masters
       and holds its tokens and logits to that engine bitwise

    python3 chip_smoke.py            # all phases (needs one CUDA card)
    python3 chip_smoke.py --quick    # build + kernel-vs-plain checks only

It refuses to start with ``REPRO_LADDER`` or ``REPRO_CHAOS`` set: phases
[1]-[12] run with no ladder and no injected fault, so a kernel that does
not build or launch there fails the run.

Every phase raises on failure. The second-to-last line of standard output
is the kernels' JSON record, the last line ``{"ok": true, "device": ...}``.
Per-mode details go to ``chiprun_out/chip_smoke.json``.

Tolerances (float32 throughout, TF32 off). An output element is a sum of
n float32 terms ``val * prod F`` (n = the nonzeros of its row), summed in
an order that differs between the kernel (shared-memory atomics) and
``index_add_``. With ``s`` the sum of the terms' absolute values (the same
function on absolute inputs) and ``u = 2**-24``:
  * MTTKRP outputs against ``mttkrp_ref`` computed in float64 from the
    same inputs: ``LAMBDA * (sqrt(n) + N) * u * s`` per element, the
    probabilistic bound of float32 summation of n terms in any order
    (Higham and Mary, 2019) plus N - 1 roundings per product, N the mode
    count. At n = 1e6 that is 1.2e-4 of ``s``.
  * ``out_rel`` of a kernel against its plain version, both float32:
    twice that, one share for each side.
  * The limit is held against itself: the gather kernel run with 2% of
    the hottest row's terms marked as pads (a kernel that skips work) must
    fail it; so must a kernel run with a work table that drops one of the
    hot partition's chunks, and with one that lists one of them twice, on
    the hottest row, while each agrees with the plain version of its
    schedule on its own table (the kernel does what its table says)
    within the limit of that table's terms: the compact gather kernel in
    [3], the pre-gathered one in [7], the rect gather one in [8].
  * remap outputs and the layout after a full rotation: bitwise.
  * a streamed mode ([12]) against the oracle: the limit above; against
    the resident engine's output: twice it (both float32, one share
    each); the streamed host layout before every mode: bitwise the
    resident layout's first S_d slots, and back at its start after the
    rotation. The limit is held against itself: a stream whose chunk c
    uploads chunk c - 1's slots must fail it. A streamed ``cuda_fused``
    rotation's peak device bytes must stay under the reference's budget
    model (``stream_fixed_bytes`` + ``stream_ring`` x
    ``chunk_device_bytes`` of the largest chunk) plus the port's work
    tables and largest partial buffer, and under the resident peak.
  * [14]: each distributed mode within the oracle limit above, and within
    the same limit of the single-device rotation; every layout after a
    transition bitwise ``shard_state`` of the single-device layout (the
    exchange only moves data), the two exchanges' layouts bitwise each
    other; bytes copied exactly ``n_dev`` x ``exchange_bytes``; the
    limit held against itself by a rotation with one hop dropped;
    ``cp_als(mesh=)`` fits within ``FIT_ATOL`` of the single-device run
    and the float64 witness; the rungs and the resumes on 2 and 1 shards
    within ``FIT_ATOL`` of the clean 4-shard run (the card is not
    run-to-run bitwise).
  * [13]: a resumed ``cp_als`` bitwise the clean run where two clean
    runs are bitwise equal, else within ``FIT_ATOL`` of it; the backend
    rung's fits within ``FIT_ATOL`` of [7]'s ``cuda`` fits, the NaN
    guard's of [3]'s clean fits (the replayed sweep's stronger ridge,
    1e-3 against Gram products of unit-norm columns, moves them by ~2e-6
    on an H100); every streamed mode after a rung within the oracle
    limit above.
  * CPD fits, cuda_fused ([3]) and cuda ([7]) against the torch backend
    from the same initial factors: ``FIT_ATOL`` (the per-mode differences
    above, through three sweeps of R x R solves), on ``FIT_SEEDS`` draws
    of those factors; and each within ``FIT_ATOL`` of a float64 witness
    (``cp_als_reference`` in float64 from the same factors), which also
    says which of the two float32 runs a gap between them comes from.
  * ``wkv6`` against its plain version, both float32. With ``A`` the same
    recurrence on ``|r|, |k|, w, |v|, |u|`` (in float64): per element
    ``2 * LAMBDA * (2 sqrt(t + 1) + sqrt(K) + 3) * u * A``. Each step
    rounds the state update at most twice (relative to the state, which
    on absolute inputs never exceeds ``A``'s state, since the decays are
    positive), so after t + 1 steps the state carries a random walk of
    ~2 sqrt(t + 1) roundings; the readout is a sum of K terms, and each
    term has ~3 roundings of its own; one share for each side. The limit
    is held against itself: the kernel run with u = 0 (no bonus term),
    with w shifted one step late (w_{t-1} in step t), and with r zeroed
    in one of the kernel's K slices (what a readout that drops one
    quarter-warp's partial sums returns) must fail it.
  * RWKV-6 float32 cross-check, ``forward(prompt)[:, -1]`` (the kernel)
    against ``Engine.prefill(prompt)`` (the decode recurrence) at full
    width: max |difference| <= ``XCHECK_ATOL`` on logits of size ~1. The
    two differ by matmul summation order (M = B*S against M = B, sums
    over d = 2560 and d_ff = 8960, ~sqrt(d) u relative each) and the
    kernel's readout order, through 4 layers of ~10 matmuls: ~1e-4 at
    most; a wrong decay or bonus moves logits by ~1e-1. Greedy tokens
    must agree.
  * ``lru_scan`` against its plain version, both float32. With ``A_t``
    the same recurrence on ``|a|, |x|`` (in float64): per element
    ``2 * LAMBDA * 2 sqrt(t + 1) * u * A_t``. h_t is a sum of t + 1
    terms x_s a_{s+1} ... a_t. Each step rounds at most twice (the plain
    version's product and sum; the kernel's one FMA), each time by at
    most u of a value no larger than A at that step; an error made at
    step s reaches step t scaled by |a_{s+1} ... a_t|, and that product
    times A_s is at most A_t. So after t + 1 steps the state carries a
    random walk of at most 2 (t + 1) roundings of size u A_t, ~2 sqrt(t
    + 1) of them in size; one share for each side. The limit is held
    against itself: the kernel run with a shifted one step late (a_{t-1}
    in step t) and with a zeroed at the kernel's first chunk boundary
    (t = 32: a dropped carry) must fail it.
  * RecurrentGemma float32 cross-check, ``forward(prompt)[:, -1]`` (the
    kernel, the prefill attention) against ``Engine.prefill(prompt)``
    (the decode recurrence and the ring-buffer attention) at full width,
    4 layers (rec, rec, local, rec): max |difference| <= ``XCHECK_ATOL``
    on logits of size ~1, for the same reasons (sums over d = 4096 and
    d_ff = 12288, a softmax over at most 64 keys); a dropped carry or a
    wrong mask moves logits by ~1e-1. Greedy tokens must agree.
  * [15a]/[15b] float32 cross-checks, the same limit and reasons (4
    causal attention layers, d 2048, d_ff up to 11008, a softmax over at
    most 64 keys through the causal KV cache).
  * [15b] the CPD functions in float32 against float32 or float64, per
    element ``sides * LAMBDA * terms * u * s``, ``s`` the same function
    on absolute values in float64: the rows (a sum over R, one rounding
    a product) ``terms = sqrt(R) + 2``; the head (sums over D then R
    against R then D) ``sqrt(D) + sqrt(R) + 2``; dA / dB (a row's n
    tokens, each term a sum over D) ``sqrt(n) + sqrt(D) + 3``; dC (a sum
    over the T tokens) ``sqrt(T) + 2``. The gradient limit is held
    against itself: a backward whose first token's cotangent is dropped
    must fail it. [16b] holds the same gradients, at the cotangent that a
    training step's backward brings to the embedding, to the same limit.
  * ``wkv6_bwd`` against the plain backward computed in float64, every
    output: with ``A`` the same backward on ``|r|, |k|, w, |v|, |u|,
    |dy|`` (float64), which bounds every partial sum of the linear
    recurrences, per element ``LAMBDA * (2 sqrt(T) + sqrt(K) + 4) * u *
    A``: the state and its gradient each carry a random walk of ~2
    sqrt(T) roundings, a readout sums K terms, the bonus terms add ~4
    roundings. ``lru_scan_bwd`` likewise, ``LAMBDA * (2 sqrt(T - t) + 3)
    * u * A_t``. Each limit is held against itself: the kernel run with
    the carry dropped at step T / 2 (w, or a, zeroed there) must fail it.
  * [16a] the float32 4-layer step, card against CPU (TF32 off): each
    gradient leaf (the first moment after one step, (1 - b1) g) within
    ``GRAD_RTOL`` = 1e-3 of that leaf's largest element, the losses
    within 1e-4 relative. The two differ by float32 sums in another
    order (over d 2048, d_ff 5632, the 32000-way softmax; ~1e-6 of a
    leaf); the limit is held against a step whose layer-1 gradients are
    dropped.
  * [16e] the resumed run against the uninterrupted one: parameters
    within 2 lr a step after the resume (Adam's first steps move an
    element by ~lr g / (|g| + eps), whose sign flips where g is
    run-to-run noise around 0: the embedding's backward accumulates with
    atomics on the card, so the card is not run-to-run bitwise), the
    last loss within 1e-3 relative; a checkpoint loads back bitwise.
  * [17] a sharded step against the single-device step from the same
    state and batch: in bf16 ([17a] at full width, [17b]) the losses
    within 3e-2 (the reference's own bound for its sharded bf16 step),
    each gradient leaf within ``SHARD_GRAD_RTOL`` = 5e-2 of that leaf's
    largest (the same bf16 products summed over half the batch on each
    data shard and half the heads or columns on each model shard, then
    across shards in float32), every parameter within
    ``SHARD_PARAM_ATOL`` = 1e-6 (times |p| above 1) where its
    gradient's sign is sure (|m|
    at least twice the gradient limit, |g| >= 1e-5) and within 2 lr
    elsewhere (Adam's first step is sign-like); in [17b] each leaf's
    limit is at least ``SHARD_ROUND_K`` = 5 times how far the
    single-device bf16 step's leaf lies from the single-device float32
    step's: rwkv6-3b's gradients of ``u`` and ``mu`` are so
    ill-conditioned that bf16 rounding alone moves them by up to ~21x
    ``SHARD_GRAD_RTOL`` of their largest, and the sharded step up to
    ~81x, while in float64 the sharded step equals the single-device one
    to ~3e-6 of the limit (``experiments/torch_tp_bf16_noise.py``,
    ``experiments/torch_tp_f64_witness.py``); the float32
    2-layer copy (TF32 off) at ``GRAD_RTOL`` and 1e-4 relative on the
    loss, held against a step that drops the sum after ``wo`` ([17a]),
    ``w_out_t`` (rwkv6-3b) or ``w_out_rec`` (recurrentgemma-9b); the
    recurrence kernels at a model shard's shapes at [2c]'s, [2d]'s,
    [16c]'s and [16d]'s limits, with their mutants; the
    elastic restore bitwise; ``cp_als(mesh=ctx)`` within ``FIT_ATOL``;
    the pipeline within 1e-5 of its sequential stages, a full-rank
    compressed sync within 1e-4 of the mean, its error feedback the
    residual within 1e-5.
  * [18] the float32 checks as [15a]'s, [16a]'s and [17a]'s, with one
    more source of difference: a token's top-k experts are a
    discontinuous function of its router scores, which the two sides
    compute in float32 in another order (~3e-6 apart at d 2048), so a
    token whose k-th and (k+1)-th scores lie closer than that may take
    another expert on each side and move its output by ~1/k of itself.
    At a gap of ~0.07 between them (64 experts, scores of std ~0.9)
    that is ~4e-5 a routing, so the float32 checks route few tokens
    (B 2 x S 16 through 4 layers; B 1 x S 64 and B 2 x S 32 through 2):
    ~0.5% each that one token flips. The bf16 prefill and serving are
    checked for shape and finiteness; [18d]'s bf16 step at [17a]'s
    limits.
  * [19] the float32 checks as [15a]'s ([19a]–[19c]; the prefix mask's
    card-against-CPU hidden state at the same ``XCHECK_ATOL``: values
    of ~1 after the final norm, a causal mask moves them by ~1), the
    steps as [16a]'s and [17a]'s float32 copies. A gradient leaf's
    limit is ``GRAD_RTOL`` of its largest element, but at least of
    ``GRAD_ZERO`` = 1e-6 of the step's largest: whisper's key biases
    have a zero gradient but for float32 rounding (a softmax does not
    change when one vector is added to every key), so their float32
    noise is held to the rounding of the sums it comes from.
  * [19d] the int8 KV cache: each int8 row and scale against
    ``_quantize_rows`` of the float engine's row (one layer: both
    engines' layer input is the step's embedding), exactly, or one step
    off where the row sits on a rounding tie (|x / s| within 1e-5 of a
    half-integer). The logits: rounding to the nearest step moves each
    cached element by at most half a step, s / 2 (s the row's largest
    |x| over 127). The yardstick is the float engine's logits after
    ``KVQ_DRAWS`` moves of every cached key and value by a uniform draw
    within that half step (what rounding does to values spread over
    many steps: rounding errors of a row behave as independent uniform
    draws of variance s^2 / 12). At every step the int8 logits'
    difference from the float engine's, over the B x V logits, must
    stay within ``KVQ_RATIO`` = 2 of the draws', in root mean square
    and in largest |difference|; the same function of 4 draws is
    stable to a few percent at V 256,000. Rows read back without their
    scales (each element 1 / s times too large) must miss it.
  * [20] each call's matmul FLOPs traced on ``meta`` equal
    ``FlopCounterMode``'s count of the call on the card exactly: the
    trace runs the same Python code, so the same aten ops on the same
    shapes. The predicted temporaries (the trace's peak less its
    arguments, with the CUDA kernels' own scratch of
    ``analysis.cost._SCRATCH``) are within ``DRY_PEAK_RTOL`` = 2% of the
    bytes the call allocates above what was allocated before it: the
    two prefills matched to the byte and the step within 0.01% of its
    9.37 GB on an H100; what is left is the allocator's 512-byte blocks and
    any kernel scratch the table does not know, and 2% is 187 MB at the
    step's 9.37 GB. A tracker that never frees (every storage the call makes)
    is 100 times or more off and must miss it. The roofline's largest
    term, the FLOPs (formulas and the kernels' charges) over 989 TFLOP/s
    or the bytes (each op's inputs read once and outputs written once)
    over 3.35 TB/s, must not exceed the call's CUDA-event time: a bound
    above the measured time means a count is wrong.
  * [21] and the graph gate of serving: bitwise. A replay runs the same
    kernels on the same inputs as the eager code it captured: the
    rotation's layouts always, its outputs where two eager rotations
    repeat bitwise (the spMTTKRP kernels' atomics do not on an H100, so
    their outputs are held to the oracle limit above); the graph engine's
    tokens and last logits against the eager loop on the float32
    masters (a bf16 working copy holds the values a cast at use
    makes). ``cp_als`` through the graph within ``FIT_ATOL`` of the
    eager loop (the same atomics).
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

U = 2.0 ** -24                 # float32 unit roundoff
LAMBDA = 2.0
GATE_DROP = 0.02               # share of the hottest row's terms dropped
FIT_ATOL = 1e-5
FIT_SEEDS = (0, 1, 2)          # initial-factor seeds of the fit check
XCHECK_ATOL = 1e-3
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
F32_FLOP_PER_S = 67e12         # H100 SXM f32 outside the tensor cores
RANK = 32
MEASURE_REPS = 5               # [9]: rotations a spec, median taken
CSRC = "src/repro_torch/kernels/csrc/"
SOURCES = {
    "mttkrp_fused_remap_compact": CSRC + "mttkrp_balanced.cu",
    "mttkrp_fused_gather_compact": CSRC + "mttkrp_balanced.cu",
    "mttkrp_fused_compact": CSRC + "mttkrp_pregathered.cu",
    "mttkrp_fused_remap": CSRC + "mttkrp_gather.cu",
    "mttkrp_fused_gather": CSRC + "mttkrp_gather.cu",
    "mttkrp_fused": CSRC + "mttkrp_pregathered.cu",
    "wkv6": CSRC + "wkv6.cu",
    "lru_scan": CSRC + "lru_scan.cu",
}
REPLACES = {
    "mttkrp_fused_remap_compact": "src/repro/kernels/mttkrp_kernel.py:583",
    "mttkrp_fused_gather_compact": "src/repro/kernels/mttkrp_kernel.py:466",
    "mttkrp_fused_compact": "src/repro/kernels/mttkrp_kernel.py:173",
    "mttkrp_fused_remap": "src/repro/kernels/mttkrp_kernel.py:517",
    "mttkrp_fused_gather": "src/repro/kernels/mttkrp_kernel.py:420",
    "mttkrp_fused": "src/repro/kernels/mttkrp_kernel.py:132",
    "wkv6": "src/repro/kernels/wkv6.py:53",
    "lru_scan": "src/repro/kernels/lru_scan.py:44",
}
RECT_NEW = ("mttkrp_fused_remap", "mttkrp_fused_gather", "mttkrp_fused")
BALANCED = ("mttkrp_fused_remap_compact", "mttkrp_fused_gather_compact")


def log(msg: str) -> None:
    print(msg, flush=True)


# --------------------------------------------------------------------------
# Helpers.
# --------------------------------------------------------------------------
def limit(abs_sum, terms, nmodes, sides=1):
    """Per-element limit on a float32 sum of ``terms`` products whose
    absolute values sum to ``abs_sum`` (see the module docstring)."""
    return sides * LAMBDA * (terms.double().sqrt() + nmodes) * U * abs_sum


def close_to(name, got, want, lim):
    """|got - want| <= lim elementwise; returns (max error, max error as
    a share of its element's limit)."""
    import torch

    if not torch.isfinite(got).all():
        raise AssertionError(f"{name}: non-finite output")
    err = (got.double() - want.double()).abs()
    bad = err > lim
    if bad.any():
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements off; max err "
            f"{float(err.max()):.3e}, max |want| {float(want.abs().max()):.3e}")
    if not err.numel():
        return 0.0, 0.0
    share = torch.where(lim > 0, err / lim, 0.0)
    return float(err.max()), float(share.max())


def exact(name, got, want):
    import torch

    if not torch.equal(got, want):
        raise AssertionError(f"{name}: not bitwise equal")


def kernel_args(factors, d, state):
    plan = state.statics[d]
    inputs = tuple(f for w, f in enumerate(factors) if w != d)
    kw = dict(kappa=plan.kappa, rows_pp=plan.rows_pp, nblocks=plan.nblocks,
              block_p=plan.block_p)
    return inputs, kw


def layout_work(kmt, L):
    """The mode's work table, as ``engine.init`` keeps it in the state."""
    return kmt.WorkTable(L["work"], L["wsum"])


def run_remap(kmt, L, inputs, kw, smax, nxt, plain=False):
    if plain:
        return kmt.mttkrp_fused_remap_compact_plain(
            L["val"], L["idx"], L["alpha"], L["lrow"], L["upos"], L["bpart"],
            L["uidx"], L["nuniq"], inputs, smax=smax, next_mode=nxt, **kw)
    return kmt.mttkrp_fused_remap_compact(
        L["val"], L["idx"], L["alpha"], L["lrow"], L["upos"], L["bpart"],
        L["uidx"], L["nuniq"], inputs, smax=smax, next_mode=nxt,
        pstart=L["pstart"], work=layout_work(kmt, L), **kw)


def run_gather(kmt, L, inputs, kw, plain=False, work=None):
    if plain:
        return kmt.mttkrp_fused_gather_compact_plain(
            L["val"], L["lrow"], L["upos"], L["bpart"], L["uidx"],
            L["nuniq"], inputs, **kw)
    return kmt.mttkrp_fused_gather_compact(
        L["val"], L["lrow"], L["upos"], L["bpart"], L["uidx"], L["nuniq"],
        inputs, pstart=L["pstart"], work=work or layout_work(kmt, L), **kw)


def run_chunked(kmt, L, inputs, kw, work):
    return kmt.chunked_plain(L["val"], L["lrow"], L["upos"], L["bpart"],
                             L["uidx"], L["nuniq"], inputs, work=work, **kw)


def row_stats(kmt, L, inputs, kw):
    """The plain gather on absolute inputs and on ones: per ``out_rel``
    element, the absolute sum of its terms and their count."""
    import torch

    abs_sum = run_gather(kmt, dict(L, val=L["val"].abs()),
                         tuple(f.abs() for f in inputs), kw, plain=True)
    terms = run_gather(kmt, dict(L, val=torch.ones_like(L["val"])),
                       tuple(torch.ones_like(f) for f in inputs), kw,
                       plain=True)
    return abs_sum, terms


def check_mode_kernels(kmt, state, L, factors, d, tag):
    """Both kernels against their plain versions on mode ``d``'s layout
    ``L``; returns each kernel's max |kernel - plain| on ``out_rel``."""
    inputs, kw = kernel_args(factors, d, state)
    nxt = (d + 1) % state.nmodes
    got = run_remap(kmt, L, inputs, kw, state.smax, nxt)
    want = run_remap(kmt, L, inputs, kw, state.smax, nxt, plain=True)
    lim = limit(*row_stats(kmt, L, inputs, kw), state.nmodes, sides=2)
    errs = {"mttkrp_fused_remap_compact": close_to(
        f"{tag} mode {d} remap out_rel", got[0], want[0], lim)[0]}
    for name, g, w in zip(("nval", "nidx", "nalpha"), got[1:], want[1:]):
        exact(f"{tag} mode {d} {name}", g, w)
    gout = run_gather(kmt, L, inputs, kw)
    errs["mttkrp_fused_gather_compact"] = close_to(
        f"{tag} mode {d} gather out_rel", gout, want[0], lim)[0]
    return errs


def gate_check(kmt, state, factors):
    """The kernel-vs-plain limit must reject a kernel that skips work: the
    gather kernel run with the last ``GATE_DROP`` of the hottest row's
    slots marked as pads. Returns what the check reads on that row."""
    import torch
    from repro_torch.engine.api import mode_layout

    d = state.mode
    plan = state.statics[d]
    L = mode_layout(state, (state.val, state.idx, state.alpha), d)
    inputs, kw = kernel_args(factors, d, state)
    abs_sum, terms = row_stats(kmt, L, inputs, kw)
    hot = int(terms[:, 0].argmax())
    slot = torch.arange(L["val"].shape[0], device=L["val"].device)
    gid = (L["bpart"].index_select(0, slot // plan.block_p).long()
           * plan.rows_pp + L["lrow"].long())
    hits = torch.nonzero((L["lrow"] >= 0) & (gid == hot)).squeeze(1)
    k = int(hits.numel() * GATE_DROP)
    lrow = L["lrow"].clone()
    lrow[hits[hits.numel() - k:]] = -1
    got = run_gather(kmt, dict(L, lrow=lrow), inputs, kw)[hot]
    want = run_gather(kmt, L, inputs, kw, plain=True)[hot]
    lim = limit(abs_sum[hot], terms[hot], state.nmodes, sides=2)
    err = (got.double() - want.double()).abs()
    out = {"mode": d, "row_terms": hits.numel(), "dropped": k,
           "elements_caught": int((err > lim).sum()), "elements": err.numel(),
           "max_err_over_limit": float((err / lim).max()),
           "max_err_over_abs_sum": float((err / abs_sum[hot]).max())}
    if out["elements_caught"] == 0:
        raise AssertionError(f"the limit misses a kernel that drops {k} of "
                             f"the hottest row's {hits.numel()} terms: {out}")
    return out


def table_gate(kmt, state, factors, name="mttkrp_fused_gather_compact"):
    """Kernel ``name`` must follow its work table, and the kernel-vs-plain
    limit must catch a table that loses or repeats work: the kernel run
    with the state's chunks minus one of the hot partition's, and with
    one of them listed twice. Each run must agree with its plain schedule
    (``chunked_plain``, ``chunked_plain_pregathered`` or
    ``chunked_plain_gather``) on its own table, within the limit of that
    table's terms, and fail the limit against the plain version on the
    hottest row. Returns what the check reads on that row."""
    import numpy as np
    import torch
    from repro_torch.engine.api import mode_layout

    d = state.mode
    plan = state.statics[d]
    L = mode_layout(state, (state.val, state.idx, state.alpha), d)
    ones = torch.ones_like
    if name in BALANCED:
        inputs, kw = kernel_args(factors, d, state)

        def kernel(work):
            return run_gather(kmt, L, inputs, kw, work=work)

        def chunked(lay, fs, work):
            return run_chunked(kmt, lay, tuple(f for w, f in enumerate(fs)
                                               if w != d), kw, work)

        want = run_gather(kmt, L, inputs, kw, plain=True)
        abs_sum, terms = row_stats(kmt, L, inputs, kw)
    else:
        def kernel(work):
            return run_new(kmt, name, L, factors, d, plan, work=work)

        def chunked(lay, fs, work):
            return run_new(kmt, name, lay, fs, d, plan, work=work,
                           chunked=True)

        want = run_new(kmt, name, L, factors, d, plan, plain=True)
        abs_sum, terms = torch_row_stats(L, factors, d, plan, state.config)
    hot = int(terms[:, 0].argmax())
    part = hot // plan.rows_pp
    table = layout_work(kmt, L).chunks.cpu().numpy()[:, :3].astype("int64")
    chunks = table[np.lexsort((table[:, 1], table[:, 0]))]
    pstart = L["pstart"].cpu().numpy()
    rows = np.flatnonzero(chunks[:, 0] == part)
    if len(rows) < 2:
        raise AssertionError(f"the hot partition {part} is not split")
    want = want[hot]
    lim = limit(abs_sum[hot], terms[hot], state.nmodes, sides=2)
    out = {"kernel": name, "mode": d, "partition": part,
           "chunks": len(rows), "cap": table_cap(kmt, L, plan),
           "row_terms": int(terms[hot, 0])}
    for mname, mutant in (
            ("drop", np.delete(chunks, rows[1], 0)),
            ("repeat", np.insert(chunks, rows[1], chunks[rows[1]], 0))):
        work = kmt.work_from_chunks(mutant, pstart).to(L["val"].device)
        got = kernel(work)
        own = limit(chunked(dict(L, val=L["val"].abs()),
                            [f.abs() for f in factors], work),
                    chunked(dict(L, val=ones(L["val"])),
                            [ones(f) for f in factors], work),
                    state.nmodes, sides=2)
        close_to(f"mode {d} {name} on the '{mname}' table vs its plain "
                 "schedule", got, chunked(L, factors, work), own)
        err = (got[hot].double() - want.double()).abs()
        out[mname] = {"elements_caught": int((err > lim).sum()),
                      "elements": err.numel(),
                      "max_err_over_limit": float((err / lim).max())}
        if out[mname]["elements_caught"] == 0:
            raise AssertionError(f"the limit misses {name} whose table "
                                 f"does '{mname}' on a hot chunk: {out}")
    return out


def fit_witness(t, cfg, cfg_t, prior=None):
    """``cp_als`` (3 sweeps) on ``cfg`` (a kernel backend) and on the torch
    backend, both float32, against the float64 ALS of
    ``cp_als_reference`` from the same initial factors, for each seed of
    ``FIT_SEEDS``: per seed the largest fit difference of the two float32
    runs and of each to the witness; ``cfg``'s differences to the torch
    backend and to the witness are gated by ``FIT_ATOL``. ``prior`` (the
    rows of an earlier call on the same tensor) lends its torch-backend
    and float64 fits instead of running them again."""
    import torch
    from repro_torch.core import cp_als, cp_als_reference, init_factors

    def gap(x, y):
        return max(abs(p - q) for p, q in zip(x, y))

    rows = []
    for i, seed in enumerate(FIT_SEEDS):
        f = init_factors(torch.Generator(device="cuda").manual_seed(seed),
                         t.dims, RANK)
        a = cp_als(t, RANK, iters=3, config=cfg, factors=f).fits
        if prior is None:
            b = cp_als(t, RANK, iters=3, config=cfg_t, factors=f).fits
            w = cp_als_reference(t.indices, t.values, t.dims, RANK, iters=3,
                                 factors=f, device="cuda",
                                 dtype=torch.float64).fits
        else:
            b, w = prior[i]["torch_fits"], prior[i]["f64_fits"]
        rows.append({"seed": seed, "backend": cfg.backend, "fits": a,
                     "torch_fits": b, "f64_fits": w, "fit_diff": gap(a, b),
                     "to_f64": gap(a, w), "torch_to_f64": gap(b, w)})
        if not all(x == x and abs(x) < 1e30 for x in a + b + w) \
                or max(gap(a, b), gap(a, w)) > FIT_ATOL:
            raise AssertionError(f"fit check, seed {seed}: {rows[-1]}")
    return rows


def witness_line(witness):
    return ", ".join(f"{w['seed']}: {w['fit_diff']:.2e} {w['to_f64']:.2e} "
                     f"{w['torch_to_f64']:.2e}" for w in witness)


def mttkrp_oracle(indices, values, factors, dims):
    """Per mode: ``mttkrp_ref`` in float64 from the same float32 inputs,
    and the per-element limit of a float32 result against it."""
    import torch
    from repro_torch.core import mttkrp_ref

    f64 = [f.double() for f in factors]
    abs64 = [f.abs() for f in f64]
    out = []
    for d, dim in enumerate(dims):
        terms = torch.bincount(indices[:, d], minlength=dim)[:, None]
        out.append((mttkrp_ref(indices, values, f64, d, dim),
                    limit(mttkrp_ref(indices, values.abs(), abs64, d, dim),
                          terms, len(dims))))
    return out


def cuda_ms(fn, reps):
    """Mean CUDA-event milliseconds of ``fn`` over ``reps`` launches after
    one warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def cuda_median_ms(fn, reps, warm=True):
    """Median CUDA-event milliseconds of ``reps`` single calls of ``fn``
    after one warm-up (``warm=False``: the caller's last call was
    one)."""
    import statistics

    import torch

    if warm:
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def byte_bound(L, plan, d, smax, n, rank, remap):
    """Bytes the function must move on this run's data: each input read
    once, each output written once; the dedup tables read to ``nuniq``,
    and of each input factor only the rows that the alive slots use."""
    import torch

    s = plan.padded_nnz
    nm1 = n - 1
    alive = L["lrow"] >= 0
    rows_used = sum(int(torch.unique(L["idx"][:, w][alive]).numel())
                    for w in range(n) if w != d)
    b = 4 * (s * (2 + nm1)                      # val, lrow, upos
             + plan.kappa + 1                   # pstart
             + int(L["nuniq"].sum())            # uidx entries used
             + nm1 * plan.nblocks               # nuniq
             + rows_used * rank                 # factor rows used
             + plan.relabeled_rows * rank)      # out_rel
    if remap:
        b += 4 * (2 * s * n + smax * (1 + 2 * n))
    return b, rows_used


# --------------------------------------------------------------------------
# Phases.
# --------------------------------------------------------------------------
def phase_card():
    import numpy
    import torch
    from repro_torch.kernels import build

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[1] device {name} | torch {torch.__version__} cuda "
        f"{torch.version.cuda} numpy {numpy.__version__} | count "
        f"{torch.cuda.device_count()}")
    log(smi)
    t0 = time.perf_counter()
    build.build_all()
    log(f"[1] nvcc build {time.perf_counter() - t0:.1f} s")
    for lib, text in build.BUILD_LOG.items():
        for line in text.splitlines():
            if ("ptxas info" in line and ("registers" in line
                                          or "Compiling" in line)
                    or "spill" in line):
                log(f"[1] {lib}: {line.strip()}")
    return name, smi


def toy_cases():
    """Phase 2's tensors, nmodes 3-6: ``(tag, constructor, its arguments,
    rank, dedup)``."""
    from repro_torch.core import random_tensor, zipf_tensor

    return [
        ("random3", random_tensor, dict(dims=(230, 170, 110), nnz=7000,
                                        seed=3, rows_pp=16, block_p=128),
         32, True),
        ("zipf4-heavy-dedup", zipf_tensor,
         dict(dims=(500, 400, 300, 200), nnz=20000, a=2.0, seed=4,
              rows_pp=16, block_p=128), 32, True),
        ("random5-empty-parts", random_tensor,
         dict(dims=(64, 50, 40, 30, 20), nnz=40, seed=5, rows_pp=2,
              block_p=32), 16, True),
        ("zipf6-trivial-tables", zipf_tensor,
         dict(dims=(40, 30, 20, 10, 8, 6), nnz=3000, a=1.5, seed=6,
              rows_pp=8, block_p=32), 8, False),
    ]


def phase_kernels(kmt):
    """Kernels against plain versions, nmodes 3-6: random, heavy dedup,
    empty partitions, trivial (dedup-off) tables."""
    import torch
    from repro_torch import engine
    from repro_torch.engine import ExecutionConfig

    cases = [(tag, make(**kw), rank, dedup)
             for tag, make, kw, rank, dedup in toy_cases()]
    from repro_torch.engine.api import mode_layout

    g = torch.Generator(device="cuda").manual_seed(0)
    for tag, t, rank, dedup in cases:
        empty = sum(int((p.part_nnz == 0).sum()) for p in t.plans)
        heavy = [float(t.dedup_tables(d)[2].sum()
                       / max(1, (t.plans[d].part_nnz.sum()) * (t.nmodes - 1)))
                 for d in range(t.nmodes)]
        state = engine.init(t, ExecutionConfig(backend="cuda_fused",
                                               dedup=dedup))
        factors = [torch.randn((d, rank), generator=g, device="cuda")
                   for d in t.dims]
        err = 0.0
        for _ in range(t.nmodes):
            d = state.mode
            L = mode_layout(state, (state.val, state.idx, state.alpha), d)
            err = max(err, *check_mode_kernels(kmt, state, L, factors, d,
                                               tag).values())
            _, state = engine.mttkrp(state, factors)
        torch.cuda.synchronize()
        log(f"[2] {tag}: nmodes {t.nmodes} R {rank} empty partitions "
            f"{empty} unique-rows/slot {min(heavy):.3f} max|err| {err:.2e} ok")
        if tag.endswith("empty-parts") and empty == 0:
            raise AssertionError("empty-partition case has none")


def main_path(kmt, report):
    """Phases 3-4: nell1 through the entry points, both kernel paths."""
    import torch
    from repro_torch import engine
    from repro_torch.core import (build_flycoo, cp_als, init_factors, spec,
                                  synthesize)
    from repro_torch.engine import ExecutionConfig

    t0 = time.perf_counter()
    ts = spec("nell1", scale=0.1)
    indices, values = synthesize(ts, seed=0)
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK)
    n = len(ts.dims)
    t = build_flycoo(indices, values, ts.dims,
                     kappa=[cfg.kappa_for(i, n) for i in ts.dims],
                     block_p=cfg.block_p)
    for d in range(n):
        t.dedup_tables(d)
    log(f"[3] nell1 scale 0.1: dims {ts.dims} nnz {t.nnz} host setup "
        f"{time.perf_counter() - t0:.1f} s")
    factors = init_factors(torch.Generator(device="cuda").manual_seed(0),
                           t.dims, RANK)
    idx_d = torch.from_numpy(indices).cuda()
    val_d = torch.from_numpy(values).cuda()
    oracle = mttkrp_oracle(idx_d, val_d, factors, t.dims)

    # ---- main path: fused EC + remap (the default rotation) ------------
    torch.cuda.reset_peak_memory_stats()
    kmt.reset_launch_counts()
    state0 = engine.init(t, cfg)
    outs, state1 = engine.all_modes(state0, factors)
    res = cp_als(t, RANK, iters=3, config=cfg, factors=factors)
    torch.cuda.synchronize()
    remap_launches = kmt.LAUNCHES["mttkrp_fused_remap_compact"]
    reduce_launches = kmt.LAUNCHES["mttkrp_balanced_reduce"]
    peak = torch.cuda.max_memory_allocated()
    if remap_launches == 0:
        raise AssertionError("main path never launched "
                             "mttkrp_fused_remap_compact")
    errs, shares = zip(*(close_to(f"nell1 mode {d} vs mttkrp_ref", outs[d],
                                  *oracle[d]) for d in range(n)))
    for name in ("val", "idx", "alpha"):
        exact(f"nell1 layout {name} after rotation", getattr(state1, name),
              getattr(state0, name))
    cfg_t = ExecutionConfig(backend="torch", rank_hint=RANK)
    ref = cp_als(t, RANK, iters=3, factors=factors, config=cfg_t)
    # The yardstick's own distance to the float64 oracle, for comparison,
    # over all rows and on each mode's hottest row (the longest sum).
    outs_t, _ = engine.all_modes(engine.init(t, cfg_t), factors)
    torch_shares = [close_to(f"nell1 torch backend mode {d} vs mttkrp_ref",
                             outs_t[d], *oracle[d])[1] for d in range(n)]
    hot_shares = []
    for d in range(n):
        hot = int(torch.bincount(idx_d[:, d]).argmax())
        want, lim = oracle[d][0][hot], oracle[d][1][hot]
        hot_shares.append([float(((o[d][hot].double() - want).abs()
                                  / lim).max()) for o in (outs, outs_t)])
    del outs_t
    fits = res.fits
    if not all(map(lambda f: f == f and abs(f) < 1e30, fits)):
        raise AssertionError(f"non-finite fits {fits}")
    fit_diff = max(abs(a - b) for a, b in zip(fits, ref.fits))
    if fit_diff > FIT_ATOL:
        raise AssertionError(f"fits {fits} vs torch backend {ref.fits}")
    witness = fit_witness(t, cfg, cfg_t)
    gate = gate_check(kmt, state0, factors)
    tgate = table_gate(kmt, state0, factors)
    log(f"[3] all_modes == mttkrp_ref on 3 modes (max err {max(errs):.3e}, "
        f"{max(shares):.2e} of the limit; the torch backend "
        f"{max(torch_shares):.2e}); layout bitwise back; remap "
        f"launches {remap_launches} (second pass {reduce_launches}); cp_als "
        f"fits {fits} (torch backend {ref.fits}, max diff {fit_diff:.2e}); "
        f"peak {peak / 2**30:.2f} GiB")
    log("[3] hottest row of each mode, max error as a share of its limit "
        "(cuda_fused, torch backend): " + ", ".join(
            f"mode {d} {a:.3f} {b:.3f}" for d, (a, b) in enumerate(hot_shares)))
    log("[3] fits against the float64 witness, max over 3 sweeps "
        "(seed: cuda_fused-torch, cuda_fused-f64, torch-f64): "
        + witness_line(witness))
    log(f"[3] limit check: {gate}")
    log(f"[3] work-table check: {tgate}")
    report["nell1"] = {"dims": ts.dims, "nnz": t.nnz, "fits": fits,
                       "torch_fits": ref.fits, "fit_diff": fit_diff,
                       "max_err": max(errs), "max_err_share": max(shares),
                       "max_err_shares": shares,
                       "torch_max_err_shares": torch_shares,
                       "hot_row_shares": hot_shares,
                       "gate_check": gate, "table_gate": tgate,
                       "fit_witness": witness,
                       "peak_bytes": peak,
                       "rows_pp": [p.rows_pp for p in t.plans],
                       "kappa": [p.kappa for p in t.plans],
                       "second_pass_launches": reduce_launches}

    # ---- the same rotation with fuse_remap=False ------------------------
    cfg_g = ExecutionConfig(backend="cuda_fused", rank_hint=RANK,
                            fuse_remap=False)
    kmt.reset_launch_counts()
    state_g = engine.init(t, cfg_g)
    outs_g, state_g1 = engine.all_modes(state_g, factors)
    torch.cuda.synchronize()
    gather_launches = kmt.LAUNCHES["mttkrp_fused_gather_compact"]
    if gather_launches == 0:
        raise AssertionError("fuse_remap=False never launched "
                             "mttkrp_fused_gather_compact")
    for d in range(n):
        close_to(f"nell1 fuse_remap=False mode {d}", outs_g[d], *oracle[d])
    for name in ("val", "idx", "alpha"):
        exact(f"nell1 fuse_remap=False layout {name}",
              getattr(state_g1, name), getattr(state_g, name))
    log(f"[4] fuse_remap=False all_modes == mttkrp_ref; gather launches "
        f"{gather_launches} (second pass "
        f"{kmt.LAUNCHES['mttkrp_balanced_reduce']})")
    return t, state0, factors, {"mttkrp_fused_remap_compact": remap_launches,
                                "mttkrp_fused_gather_compact":
                                    gather_launches}


def phase_twitch(kmt):
    import torch
    from repro_torch import engine
    from repro_torch.core import build_flycoo, init_factors, spec, synthesize
    from repro_torch.engine import ExecutionConfig

    t0 = time.perf_counter()
    ts = spec("twitch", scale=0.01)
    indices, values = synthesize(ts, seed=0)
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK)
    n = len(ts.dims)
    t = build_flycoo(indices, values, ts.dims,
                     kappa=[cfg.kappa_for(i, n) for i in ts.dims],
                     block_p=cfg.block_p)
    factors = init_factors(torch.Generator(device="cuda").manual_seed(1),
                           t.dims, RANK)
    state0 = engine.init(t, cfg)
    log(f"[5] twitch scale 0.01: dims {ts.dims} nnz {t.nnz} host setup "
        f"{time.perf_counter() - t0:.1f} s")
    outs, state1 = engine.all_modes(state0, factors)
    oracle = mttkrp_oracle(torch.from_numpy(indices).cuda(),
                           torch.from_numpy(values).cuda(), factors, t.dims)
    for d in range(n):
        close_to(f"twitch mode {d} vs mttkrp_ref", outs[d], *oracle[d])
    for name in ("val", "idx", "alpha"):
        exact(f"twitch layout {name}", getattr(state1, name),
              getattr(state0, name))
    log("[5] 5-mode all_modes == mttkrp_ref; layout bitwise back")
    return indices, values, ts.dims


def alive_extents(L, plan):
    """Under rect, each partition's alive blocks, ``ceil(alive slots /
    P)``, counted from the layout's ``lrow``."""
    import torch

    alive = (L["lrow"] >= 0).view(plan.kappa, -1).sum(1)
    return torch.div(alive + plan.block_p - 1, plan.block_p,
                     rounding_mode="floor").cpu()


def table_cap(kmt, L, plan):
    """The cap the engine's table was built at: ``default_cap`` of the
    blocks (compact) or of the alive blocks (rect)."""
    if plan.schedule == "rect":
        return kmt.default_cap(int(alive_extents(L, plan).sum()))
    return kmt.default_cap(plan.nblocks)


def work_stats(kmt, L, plan, rank):
    """What a mode's work table asks of its kernels: chunks (= CTAs of the
    main launch), split partitions, the blocks it lists, the longest
    chunk and the busiest partition in blocks, and the partials the
    second pass reads (count and bytes, each written once and read once).
    Raises if a chunk exceeds the cap, or if under rect the table lists
    other blocks than each partition's alive extent, once each."""
    import torch

    work = layout_work(kmt, L)
    ch = work.chunks.cpu().long()
    ps = L["pstart"].cpu()
    cap = table_cap(kmt, L, plan)
    out = {"chunks": int(ch.shape[0]), "cap": cap,
           "split_partitions": int((work.wsum[:, 1] > 0).sum()),
           "listed_blocks": int((ch[:, 2] - ch[:, 1]).sum()),
           "longest_chunk_blocks": int((ch[:, 2] - ch[:, 1]).max()),
           "busiest_partition_blocks": int((ps[1:] - ps[:-1]).max()),
           "partials": work.n_partials,
           "partial_bytes": 4 * work.n_partials * plan.rows_pp * rank}
    if out["longest_chunk_blocks"] > cap:
        raise AssertionError(f"a chunk of {out['longest_chunk_blocks']} "
                             f"blocks exceeds the cap {cap}")
    if plan.schedule == "rect":
        ext = alive_extents(L, plan)
        want = torch.zeros(plan.nblocks, dtype=torch.long)
        for j, e in enumerate(ext.tolist()):
            want[j * plan.blocks_pp:j * plan.blocks_pp + e] = 1
        got = torch.zeros(plan.nblocks + 1, dtype=torch.long)
        got.index_add_(0, ch[:, 1], torch.ones(len(ch), dtype=torch.long))
        got.index_add_(0, ch[:, 2], -torch.ones(len(ch), dtype=torch.long))
        if not torch.equal(got.cumsum(0)[:-1], want):
            raise AssertionError("the rect table lists other blocks than "
                                 "the partitions' alive extents")
        out["busiest_partition_blocks"] = int(ext.max())
    return out


def work_line(ws):
    return (f"{ws['chunks']} chunks (cap {ws['cap']}), "
            f"{ws['listed_blocks']} blocks listed, longest "
            f"{ws['longest_chunk_blocks']} (busiest partition "
            f"{ws['busiest_partition_blocks']}), {ws['split_partitions']} "
            f"split partitions, {ws['partials']} partials "
            f"({ws['partial_bytes'] / 1e6:.2f} MB)")


def phase_times(kmt, t, state0, factors, report, reps):
    """Per mode at the main path's shapes: both kernels against their
    plain versions, then kernel, plain version and torch backend times
    (CUDA events), the balanced kernels' main launch and second pass
    timed apart, byte bound, partition imbalance and the work table.
    Returns the rows and each kernel's max |kernel - plain| on the
    modes."""
    from repro_torch import engine
    from repro_torch.engine.api import mode_layout
    from repro_torch.engine.backends import ec_torch

    n = t.nmodes
    rows = []
    errs = dict.fromkeys(BALANCED, 0.0)
    state = state0
    for _ in range(n):
        d = state.mode
        plan = state.statics[d]
        L = mode_layout(state, (state.val, state.idx, state.alpha), d)
        for kname, err in check_mode_kernels(kmt, state, L, factors, d,
                                             "nell1").items():
            errs[kname] = max(errs[kname], err)
        inputs, kw = kernel_args(factors, d, state)
        nxt = (d + 1) % n
        smax = state.smax
        alive = L["lrow"] >= 0
        flops = int(alive.sum()) * RANK * n     # N-1 multiplies + 1 add
        row = {"mode": d, "dim": plan.dim, "kappa": plan.kappa,
               "rows_pp": plan.rows_pp, "nblocks": plan.nblocks,
               "slots": plan.padded_nnz}
        lb = t.plans[d].load_balance()
        row["part_nnz_max"], row["part_nnz_mean"] = lb["max"], lb["mean"]
        row["max_degree"] = lb["max_degree"]
        row["work"] = ws = work_stats(kmt, L, plan, RANK)

        def torch_step():
            out = ec_torch(L, factors, d, plan=plan, config=state.config)
            return out, kmt.remap_plain(L["val"], L["idx"], L["alpha"],
                                        smax=smax, next_mode=nxt)

        for kname, fn, plain, yard, remap in (
                ("mttkrp_fused_remap_compact",
                 lambda: run_remap(kmt, L, inputs, kw, smax, nxt),
                 lambda: run_remap(kmt, L, inputs, kw, smax, nxt, True),
                 torch_step, True),
                ("mttkrp_fused_gather_compact",
                 lambda: run_gather(kmt, L, inputs, kw),
                 lambda: run_gather(kmt, L, inputs, kw, True),
                 lambda: ec_torch(L, factors, d, plan=plan,
                                  config=state.config), False)):
            nbytes, rows_used = byte_bound(L, plan, d, smax, n, RANK, remap)
            _, main, second = kmt.balanced_passes(
                L["val"], L["lrow"], L["upos"], L["bpart"], L["uidx"],
                L["nuniq"], inputs, work=layout_work(kmt, L),
                remap=(L["idx"], L["alpha"], smax, nxt) if remap else None,
                **kw)
            row[kname] = r = {
                "ms": cuda_ms(fn, reps), "main_ms": cuda_ms(main, reps),
                "second_ms": cuda_ms(second, reps) if second else 0.0,
                "plain_ms": cuda_ms(plain, reps),
                "torch_backend_ms": cuda_ms(yard, reps),
                "bytes": nbytes, "factor_rows_used": rows_used,
                "flops": flops,
                "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                      flops / F32_FLOP_PER_S),
                "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                             >= flops / F32_FLOP_PER_S else "operations")}
            main = second = None
            r["passes_ms"] = r["main_ms"] + r["second_ms"]
            log(f"[6] mode {d} {kname}: {r['ms']:.3f} ms (main "
                f"{r['main_ms']:.3f} + second pass {r['second_ms']:.3f} = "
                f"{r['passes_ms']:.3f}; plain {r['plain_ms']:.3f}, torch "
                f"backend {r['torch_backend_ms']:.3f}, bound "
                f"{r['bound_ms']:.4f})")
        log(f"[6] mode {d} work: {work_line(ws)} | part_nnz max "
            f"{lb['max']:.0f} mean {lb['mean']:.1f} kappa {plan.kappa} "
            f"rows_pp {plan.rows_pp} blocks {plan.nblocks}")
        rows.append(row)
        _, state = engine.mttkrp(state, factors)
    report["times"] = rows
    return rows, errs


# --------------------------------------------------------------------------
# The four kernels of the plan-space path: [2b], [7], [8], [9].
# --------------------------------------------------------------------------
def new_operand(name, L, factors, d):
    """The operand kernel ``name``'s backend builds in PyTorch: the
    pre-gathered ``(S, N-1, R)`` rows for ``cuda``, the ``(N-1, S)`` row
    table for rect ``cuda_fused``."""
    from repro_torch.engine.backends import fused_lidx, pregather

    if name in ("mttkrp_fused", "mttkrp_fused_compact"):
        return pregather(L["idx"], factors, d)
    return fused_lidx(L["idx"], d)


def run_new(kmt, name, L, factors, d, plan, smax=None, plain=False,
            work=None, chunked=False, operand=None):
    """Kernel ``name`` on mode ``d``'s layout ``L`` with the state's work
    table (or ``work``), on the operand its backend builds
    (:func:`new_operand`, built here unless given). ``plain=True``: its
    plain version; ``chunked=True``: the plain version of its schedule on
    ``work``."""
    if operand is None:
        operand = new_operand(name, L, factors, d)
    inputs = tuple(f for w, f in enumerate(factors) if w != d)
    fn = getattr(kmt, name + "_plain" if plain else name)
    rect = dict(kappa=plan.kappa, rows_pp=plan.rows_pp,
                blocks_pp=plan.blocks_pp, block_p=plan.block_p)
    sched = dict(kappa=plan.kappa, rows_pp=plan.rows_pp,
                 block_p=plan.block_p, work=work)
    extra = {} if plain else {"pstart": L["pstart"],
                              "work": work or layout_work(kmt, L)}
    remap = ((L["idx"], L["alpha"], smax, (d + 1) % len(factors))
             if name == "mttkrp_fused_remap" else None)
    if name in ("mttkrp_fused", "mttkrp_fused_compact"):
        if chunked:
            return kmt.chunked_plain_pregathered(operand, L["val"],
                                                 L["lrow"], **sched)
        if name == "mttkrp_fused":
            return fn(operand, L["val"], L["lrow"], **rect, **extra)
        return fn(operand, L["val"], L["lrow"], L["bpart"],
                  kappa=plan.kappa, rows_pp=plan.rows_pp,
                  nblocks=plan.nblocks, block_p=plan.block_p, **extra)
    lidx = operand
    if chunked:
        return kmt.chunked_plain_gather(L["val"], L["lrow"], lidx, inputs,
                                        **sched, remap=remap)
    if remap is None:
        return fn(L["val"], L["lrow"], lidx, inputs, **rect, **extra)
    return fn(L["val"], L["idx"], L["alpha"], L["lrow"], lidx, inputs,
              smax=smax, next_mode=remap[3], **rect, **extra)


def new_passes(kmt, name, L, factors, d, plan, smax, operand):
    """The two passes of kernel ``name`` on mode ``d``'s layout and
    ``operand`` with the state's table (``kmt.*_passes``), for timing
    them apart."""
    kw = dict(kappa=plan.kappa, rows_pp=plan.rows_pp, nblocks=plan.nblocks,
              block_p=plan.block_p, work=layout_work(kmt, L))
    if name in ("mttkrp_fused", "mttkrp_fused_compact"):
        return kmt.pregathered_passes(operand, L["val"], L["lrow"], **kw)
    inputs = tuple(f for w, f in enumerate(factors) if w != d)
    remap = ((L["idx"], L["alpha"], smax, (d + 1) % len(factors))
             if name == "mttkrp_fused_remap" else None)
    return kmt.gather_passes(L["val"], L["lrow"], operand, inputs, **kw,
                             remap=remap)


def torch_ec(L, factors, d, plan, config, smax=None):
    """The ``torch`` backend's EC (+ its ``index_copy_`` remap when
    ``smax`` is given): each kernel's multi-call yardstick."""
    from repro_torch.engine.backends import ec_torch
    from repro_torch.kernels.mttkrp import remap_plain

    out = ec_torch(L, factors, d, plan=plan, config=config)
    if smax is None:
        return out
    return out, remap_plain(L["val"], L["idx"], L["alpha"], smax=smax,
                            next_mode=(d + 1) % len(factors))


def torch_row_stats(L, factors, d, plan, config):
    """Per ``out_rel`` element, the absolute sum of its terms and their
    count (the ``torch`` backend on absolute inputs and on ones), for any
    schedule."""
    import torch

    abs_sum = torch_ec(dict(L, val=L["val"].abs()),
                       [f.abs() for f in factors], d, plan, config)
    terms = torch_ec(dict(L, val=torch.ones_like(L["val"])),
                     [torch.ones_like(f) for f in factors], d, plan, config)
    return abs_sum, terms


def check_new_kernels(kmt, state, L, factors, d, tag, names):
    """Each kernel of ``names`` against its plain version on mode ``d``'s
    layout: ``out_rel`` within the two-sided limit, remap outputs bitwise.
    Returns each kernel's max |kernel - plain|."""
    plan = state.statics[d]
    lim = limit(*torch_row_stats(L, factors, d, plan, state.config),
                state.nmodes, sides=2)
    errs = {}
    for name in names:
        got = run_new(kmt, name, L, factors, d, plan, state.smax)
        want = run_new(kmt, name, L, factors, d, plan, state.smax,
                       plain=True)
        if name == "mttkrp_fused_remap":
            for field, g, w in zip(("nval", "nidx", "nalpha"), got[1:],
                                   want[1:]):
                exact(f"{tag} mode {d} {name} {field}", g, w)
            got, want = got[0], want[0]
        errs[name] = close_to(f"{tag} mode {d} {name} out_rel", got, want,
                              lim)[0]
    return errs


def new_byte_bound(kmt, name, L, plan, d, smax, n, rank):
    """Bytes the function must move on this run's data: the work table,
    ``lrow`` for the blocks it lists (it says which slots are alive; under
    rect the plan puts the pads past each partition's alive extent, which
    the table leaves out), and for the alive slots only ``val`` and either
    their pre-gathered operand rows (``mttkrp_fused[_compact]``) or their
    ``lidx`` entries plus each factor row in use once (the gather
    kernels); ``out_rel`` written once; the remap adds the alive slots'
    ``idx`` and ``alpha`` read and the whole next layout written."""
    import torch

    work = layout_work(kmt, L)
    ch = work.chunks.cpu().long()
    listed = int((ch[:, 2] - ch[:, 1]).sum()) * plan.block_p
    alive = L["lrow"] >= 0
    a = int(alive.sum())
    b = 4 * (4 * len(ch) + 2 * work.n_partials + listed + a
             + plan.relabeled_rows * rank)
    rows_used = 0
    if name in ("mttkrp_fused", "mttkrp_fused_compact"):
        b += 4 * a * (n - 1) * rank
    else:
        rows_used = sum(int(torch.unique(L["idx"][:, w][alive]).numel())
                        for w in range(n) if w != d)
        b += 4 * (a * (n - 1) + rows_used * rank)
    if name == "mttkrp_fused_remap":
        b += 4 * (2 * a * n + smax * (1 + 2 * n))
    return b, rows_used, a


def time_new_kernels(kmt, state, factors, names, reps, tag):
    """Per mode of one rotation: each kernel of ``names`` against its
    plain version (raising), then kernel, plain and ``torch`` backend
    times (CUDA events; the operand its backend builds in PyTorch, the
    ``cuda`` backend's gather or rect ``cuda_fused``'s lidx table, timed
    apart, and the kernel's main pass and second pass apart), byte bound
    and the mode's work table (:func:`work_stats`). Returns (rows, max
    |kernel - plain| per kernel)."""
    from repro_torch import engine
    from repro_torch.engine.api import mode_layout

    n = state.nmodes
    rows, errs = [], dict.fromkeys(names, 0.0)
    for _ in range(n):
        d = state.mode
        plan = state.statics[d]
        L = mode_layout(state, (state.val, state.idx, state.alpha), d)
        for k, e in check_new_kernels(kmt, state, L, factors, d, tag,
                                      names).items():
            errs[k] = max(errs[k], e)
        row = {"mode": d, "kappa": plan.kappa, "rows_pp": plan.rows_pp,
               "nblocks": plan.nblocks, "slots": plan.padded_nnz}
        row["work"] = ws = work_stats(kmt, L, plan, RANK)
        for name in names:
            smax = state.smax if name == "mttkrp_fused_remap" else None
            nbytes, rows_used, a = new_byte_bound(kmt, name, L, plan, d,
                                                  state.smax, n, RANK)
            flops = a * RANK * n
            # The kernel's time excludes the operand its backend builds in
            # PyTorch (the pre-gathered rows, or the lidx table), timed
            # apart.
            operand = new_operand(name, L, factors, d)
            key = ("gather_ms" if name in ("mttkrp_fused",
                                           "mttkrp_fused_compact")
                   else "lidx_ms")
            r = {key: cuda_ms(functools.partial(new_operand, name, L,
                                                factors, d), reps)}
            kernel = functools.partial(run_new, kmt, name, L, factors, d,
                                       plan, state.smax, operand=operand)
            _, main, second = new_passes(kmt, name, L, factors, d, plan,
                                         state.smax, operand)
            r.update({
                "ms": cuda_ms(kernel, reps),
                "main_ms": cuda_ms(main, reps),
                "second_ms": cuda_ms(second, reps) if second else 0.0,
                "plain_ms": cuda_ms(lambda: run_new(
                    kmt, name, L, factors, d, plan, state.smax,
                    plain=True), reps),
                "torch_backend_ms": cuda_ms(lambda: torch_ec(
                    L, factors, d, plan, state.config, smax), reps),
                "bytes": nbytes, "alive_slots": a,
                "factor_rows_used": rows_used, "flops": flops,
                "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                      flops / F32_FLOP_PER_S),
                "bound_by": ("bytes" if nbytes / HBM_BYTES_PER_S
                             >= flops / F32_FLOP_PER_S else "operations")})
            r["passes_ms"] = r["main_ms"] + r["second_ms"]
            kernel = main = second = operand = None  # frees the operand
            row[name] = r
            log(f"[{tag}] mode {d} {name}: {r['ms']:.3f} ms (main "
                f"{r['main_ms']:.3f} + second pass {r['second_ms']:.3f}; "
                f"plain {r['plain_ms']:.3f}, torch backend "
                f"{r['torch_backend_ms']:.3f}, {key[:-3]} {r[key]:.3f}, "
                f"bound {r['bound_ms']:.4f}) | blocks {plan.nblocks} "
                f"kappa {plan.kappa} alive {a} of {plan.padded_nnz} slots")
        log(f"[{tag}] mode {d} work: {work_line(ws)}")
        rows.append(row)
        _, state = engine.mttkrp(state, factors)
    return rows, errs


def phase_kernels_baseline(kmt):
    """[2b] The four kernels of the plan-space path against their plain
    versions at phase 2's shapes (nmodes 3-6, empty partitions): the
    pre-gathered compact kernel on the compact plans, the rect kernels on
    rect plans of the same tensors."""
    import torch
    from repro_torch import engine
    from repro_torch.engine import ExecutionConfig
    from repro_torch.engine.api import mode_layout

    g = torch.Generator(device="cuda").manual_seed(1)
    for tag, make, kw, rank, _ in toy_cases():
        for schedule, backend, names in (
                ("compact", "cuda", ("mttkrp_fused_compact",)),
                ("rect", "cuda_fused", RECT_NEW)):
            t = make(**kw, schedule=schedule)
            state = engine.init(t, ExecutionConfig(backend=backend))
            factors = [torch.randn((d, rank), generator=g, device="cuda")
                       for d in t.dims]
            err = 0.0
            for _ in range(t.nmodes):
                d = state.mode
                L = mode_layout(state, (state.val, state.idx, state.alpha),
                                d)
                err = max(err, *check_new_kernels(
                    kmt, state, L, factors, d, f"{tag} {schedule}",
                    names).values())
                _, state = engine.mttkrp(state, factors)
            torch.cuda.synchronize()
            empty = sum(int((p.part_nnz == 0).sum()) for p in t.plans)
            log(f"[2b] {tag} {schedule}: {', '.join(names)} == plain "
                f"(empty partitions {empty}, max|err| {err:.2e})")


def check_rotation(tag, outs, oracle, state0, state1, n):
    errs, shares = zip(*(close_to(f"{tag} mode {d} vs mttkrp_ref", outs[d],
                                  *oracle[d]) for d in range(n)))
    for name in ("val", "idx", "alpha"):
        exact(f"{tag} layout {name} after rotation", getattr(state1, name),
              getattr(state0, name))
    return max(errs), max(shares)


def phase_cuda_compact(kmt, coo, factors, oracle, torch_fits, witness3,
                       report, reps):
    """[7] The plan-space path on the pre-gathered baseline at nell1 scale
    0.1 (the main path's full size): ``make_engine(coo, PlanSpec(backend=
    "cuda"), cache=PlanCache())``, one rotation against the oracle,
    ``cp_als`` under the spec's config against the ``torch`` backend's
    fits of phase 3 (same data, plans and initial factors) and against
    phase 3's float64 witness (``witness3``), the work-table gate on the
    kernel, then its times and work tables."""
    import torch
    from repro_torch import engine
    from repro_torch.core import PlanCache, cp_als
    from repro_torch.engine import PlanSpec, make_engine
    from repro_torch.engine.api import as_flycoo

    n = len(coo[2])
    spec = PlanSpec(backend="cuda", rank_hint=RANK)
    cache = PlanCache()
    t0 = time.perf_counter()
    kmt.reset_launch_counts()
    state0 = make_engine(coo, spec, cache=cache)
    host_s = time.perf_counter() - t0
    outs, state1 = engine.all_modes(state0, factors)
    t = as_flycoo(coo, spec.to_config(), cache)
    res = cp_als(t, RANK, iters=3, config=spec.to_config(), factors=factors)
    torch.cuda.synchronize()
    launches = kmt.LAUNCHES["mttkrp_fused_compact"]
    reduce_launches = kmt.LAUNCHES["mttkrp_balanced_reduce"]
    if launches == 0:
        raise AssertionError("the cuda backend never launched "
                             "mttkrp_fused_compact")
    err, share = check_rotation("[7] nell1 cuda", outs, oracle, state0,
                                state1, n)
    fit_diff = max(abs(a - b) for a, b in zip(res.fits, torch_fits))
    if not all(f == f and abs(f) < 1e30 for f in res.fits) \
            or fit_diff > FIT_ATOL:
        raise AssertionError(f"fits {res.fits} vs torch backend "
                             f"{torch_fits}")
    log(f"[7] make_engine(PlanSpec(backend='cuda')): plan + init "
        f"{host_s:.1f} s, cache {cache.stats()}; all_modes == mttkrp_ref "
        f"(max err {err:.3e}, {share:.2e} of the limit); layout bitwise "
        f"back; mttkrp_fused_compact launches {launches} (second pass "
        f"{reduce_launches}); cp_als fits {res.fits} (max diff to torch "
        f"backend {fit_diff:.2e})")
    witness = fit_witness(t, spec.to_config(), None, prior=witness3)
    log("[7] fits against the float64 witness, max over 3 sweeps "
        "(seed: cuda-torch, cuda-f64, torch-f64): " + witness_line(witness))
    tgate = table_gate(kmt, state0, factors, "mttkrp_fused_compact")
    log(f"[7] work-table check: {tgate}")
    rows, errs = time_new_kernels(kmt, state0, factors,
                                  ("mttkrp_fused_compact",), reps, "7")
    report["cuda_compact"] = {"fits": res.fits, "fit_diff": fit_diff,
                              "max_err": err, "max_err_share": share,
                              "host_s": host_s, "cache": cache.stats(),
                              "fit_witness": witness, "table_gate": tgate,
                              "second_pass_launches": reduce_launches,
                              "times": rows}
    return rows, errs, {"mttkrp_fused_compact": launches}


def phase_rect(kmt, report, reps):
    """[8] The rect schedule at nell1 scale 0.01 through ``make_engine``:
    ``cuda_fused`` with the fused remap (``mttkrp_fused_remap``), without
    it (``mttkrp_fused_gather``), and ``cuda`` (``mttkrp_fused``), each
    against the oracle with the layout bitwise back, then the work-table
    gate on ``mttkrp_fused_gather`` and the kernels' times and work tables
    (each lists only the partitions' alive extents).

    Not at scale 0.1: rect pads every partition to the hottest one, so
    mode 2 there has 1.65G slots, and one resident layout (val + idx +
    alpha, 28 B a slot at N = 3) takes 46 GB; the remap writes a second.
    At scale 0.01 both layouts take about 2 GB. The slot counts, printed
    before anything is placed, are the paper's case for the compact
    schedule (Fig. 8)."""
    import torch
    from repro_torch import engine
    from repro_torch.core import PlanCache, init_factors, spec, synthesize
    from repro_torch.engine import PlanSpec, make_engine
    from repro_torch.engine.api import as_flycoo

    t0 = time.perf_counter()
    ts = spec("nell1", scale=0.01)
    indices, values = synthesize(ts, seed=0)
    coo = (indices, values, ts.dims)
    n = len(ts.dims)
    cache = PlanCache()
    sizes = {}
    for schedule in ("compact", "rect"):
        cfg = PlanSpec(backend="cuda_fused", schedule=schedule,
                       rank_hint=RANK).to_config()
        sizes[schedule] = [p.padded_nnz for p in
                           as_flycoo(coo, cfg, cache).plans]
    smax = max(sizes["rect"])
    layout_b = smax * 4 * (1 + 2 * n)
    operand_b = smax * (n - 1) * RANK * 4
    log(f"[8] nell1 scale 0.01: dims {ts.dims} nnz {len(values)}; slots "
        f"per mode compact {sizes['compact']} rect {sizes['rect']} "
        f"({len(values) / smax:.1%} of rect S_max alive); rect layout "
        f"{layout_b / 1e9:.2f} GB (x2 during a remap), pre-gathered "
        f"operand {operand_b / 1e9:.2f} GB; host "
        f"{time.perf_counter() - t0:.1f} s")
    factors = init_factors(torch.Generator(device="cuda").manual_seed(2),
                           ts.dims, RANK)
    torch.cuda.reset_peak_memory_stats()
    oracle = mttkrp_oracle(torch.from_numpy(indices).cuda(),
                           torch.from_numpy(values).cuda(), factors, ts.dims)
    launches, timing_state = {}, None
    for backend, fuse, name in (("cuda_fused", True, "mttkrp_fused_remap"),
                                ("cuda_fused", False, "mttkrp_fused_gather"),
                                ("cuda", True, "mttkrp_fused")):
        kmt.reset_launch_counts()
        state0 = make_engine(coo, PlanSpec(backend=backend, schedule="rect",
                                           fuse_remap=fuse, rank_hint=RANK),
                             cache=cache)
        outs, state1 = engine.all_modes(state0, factors)
        torch.cuda.synchronize()
        launches[name] = kmt.LAUNCHES[name]
        reduce_launches = kmt.LAUNCHES["mttkrp_balanced_reduce"]
        if launches[name] == 0:
            raise AssertionError(f"rect {backend} never launched {name}")
        err, share = check_rotation(f"[8] rect {name}", outs, oracle,
                                    state0, state1, n)
        log(f"[8] rect {backend} fuse_remap={fuse}: all_modes == "
            f"mttkrp_ref (max err {err:.3e}, {share:.2e} of the limit); "
            f"layout bitwise back; {name} launches {launches[name]} (second "
            f"pass {reduce_launches}); peak "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        timing_state = timing_state or state0
        del outs, state1
    tgate = table_gate(kmt, timing_state, factors, "mttkrp_fused_gather")
    log(f"[8] work-table check: {tgate}")
    rows, errs = time_new_kernels(kmt, timing_state, factors, RECT_NEW, reps,
                                  "8")
    report["rect"] = {"dims": ts.dims, "nnz": len(values), "slots": sizes,
                      "layout_bytes": layout_b, "operand_bytes": operand_b,
                      "cache": cache.stats(), "table_gate": tgate,
                      "times": rows}
    return coo, cache, rows, errs, launches


ROTATION_REPS = 5              # [21]: CUDA-event rotations, median taken
ROTATION_SWEEPS = 3            # [21]: cp_als sweeps, graph and eager


@contextlib.contextmanager
def eager_rotations():
    """A context in which ``engine.all_modes`` is the eager loop
    (``all_modes_eager``): ``cp_als`` then sweeps as it did before the
    graph."""
    from repro_torch import engine

    graph = engine.all_modes
    engine.all_modes = engine.all_modes_eager
    try:
        yield
    finally:
        engine.all_modes = graph


def phase_rotation_graph(kmt, t, factors, oracle, report):
    """[21] ``all_modes`` as one CUDA graph replay at nell1 0.1 ([3]'s
    tensor and factors) on ``cuda_fused`` and ``cuda``: the replay's
    layouts bitwise those of N eager ``mttkrp`` calls (and of the start),
    its outputs bitwise the eager steps' where two eager rotations repeat
    bitwise, else within the oracle's limit (the kernels' shared-memory
    atomics add in another order each run: on an H100 neither
    ``cuda_fused`` nor ``cuda`` repeats bitwise); each kernel's
    launches counted at the replay; ms a rotation, graph (a state that
    owns the graph's buffers: no copy in) and eager, medians of
    ``ROTATION_REPS`` CUDA-event runs after a warm-up; an ALS sweep (the
    rotation with the fold) the same; ``ROTATION_SWEEPS`` ``cp_als``
    sweeps through the graph within ``FIT_ATOL`` of the eager ones."""
    import torch
    from repro_torch import engine
    from repro_torch.core import cp_als, cpd
    from repro_torch.engine import ExecutionConfig

    out = {}
    n = t.nmodes
    lam = torch.ones((RANK,), device="cuda")
    for backend in ("cuda_fused", "cuda"):
        cfg = ExecutionConfig(backend=backend, rank_hint=RANK)
        state = engine.init(t, cfg)
        eager, s = [], state
        for _ in range(n):
            o, s = engine.mttkrp(s, factors)
            eager.append(o)
        again, _ = engine.all_modes_eager(state, factors)
        repeats = all(torch.equal(a, b) for a, b in zip(eager, again))
        engine.all_modes(state, factors)      # the eager first, the capture
        kmt.reset_launch_counts()
        outs, nxt = engine.all_modes(state, factors)
        torch.cuda.synchronize()
        launches = {k: v for k, v in kmt.LAUNCHES.items() if v}
        if sum(launches.values()) < n:
            raise AssertionError(f"[21] {backend}: the replay counted "
                                 f"{launches}")
        for name in ("val", "idx", "alpha"):
            exact(f"[21] {backend} graph layout {name} vs {n} mttkrp",
                  getattr(nxt, name), getattr(s, name))
            exact(f"[21] {backend} graph layout {name} vs the start",
                  getattr(nxt, name), getattr(state, name))
        shares = []
        for d in range(n):
            if repeats:
                exact(f"[21] {backend} graph mode {d} vs eager", outs[d],
                      eager[d])
            shares.append(close_to(f"[21] {backend} graph mode {d} vs "
                                   "mttkrp_ref", outs[d], *oracle[d])[1])
        del outs, eager, again, s
        held = [nxt]

        def chain():
            held[0] = engine.all_modes(held[0], factors)[1]

        graph_ms = cuda_median_ms(chain, ROTATION_REPS)
        fresh_ms = cuda_median_ms(lambda: engine.all_modes(state, factors),
                                  ROTATION_REPS)
        eager_ms = cuda_median_ms(
            lambda: engine.all_modes_eager(state, factors), ROTATION_REPS)
        if held[0].val is not next(iter(state.graphs.values())).layout[0]:
            raise AssertionError("[21] the donated chain copies its layout")
        fold = dict(fold=cpd._als_fold, carry=lam)
        engine.all_modes(state, factors, **fold)      # eager, the capture
        sweep_ms = cuda_median_ms(
            lambda: engine.all_modes(state, factors, **fold), ROTATION_REPS)
        sweep_eager_ms = cuda_median_ms(
            lambda: engine.all_modes_eager(state, factors, **fold),
            ROTATION_REPS)
        del held, state, nxt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fits = cp_als(t, RANK, iters=ROTATION_SWEEPS, config=cfg,
                      factors=factors).fits
        graph_s = time.perf_counter() - t0
        with eager_rotations():
            t0 = time.perf_counter()
            efits = cp_als(t, RANK, iters=ROTATION_SWEEPS, config=cfg,
                           factors=factors).fits
            eager_s = time.perf_counter() - t0
        gap = max(abs(a - b) for a, b in zip(fits, efits))
        if not gap <= FIT_ATOL:
            raise AssertionError(f"[21] {backend} cp_als fits through the "
                                 f"graph {fits} vs eager {efits}")
        free_device_memory()
        out[backend] = {
            "eager_repeats_bitwise": repeats, "replay_launches": launches,
            "max_err_shares": shares, "rotation_ms": graph_ms,
            "rotation_copy_in_ms": fresh_ms, "rotation_eager_ms": eager_ms,
            "sweep_ms": sweep_ms, "sweep_eager_ms": sweep_eager_ms,
            "fits": fits, "eager_fits": efits, "fit_gap": gap,
            "cp_als_s": graph_s, "cp_als_eager_s": eager_s}
        log(f"[21] {backend}: graph all_modes layouts == {n} eager mttkrp "
            f"(bitwise); outputs "
            f"{'bitwise the eager steps' if repeats else 'within the oracle limit'}"
            f" (max {max(shares):.3f} of the limit); replay launches "
            f"{launches}; a rotation {graph_ms:.3f} ms graph (donated "
            f"chain), {fresh_ms:.3f} ms with the layout copied in, "
            f"{eager_ms:.3f} ms eager ({eager_ms / graph_ms:.2f}x); an ALS "
            f"sweep (the rotation with the fold) {sweep_ms:.3f} ms graph, "
            f"{sweep_eager_ms:.3f} ms eager; cp_als {ROTATION_SWEEPS} "
            f"sweeps {fits} vs eager {efits} (max gap {gap:.2e} <= "
            f"{FIT_ATOL}), {graph_s:.2f} s vs {eager_s:.2f} s with init "
            f"(medians of {ROTATION_REPS})")
    report["rotation_graph"] = out


def phase_autotune(coo, cache, report):
    """[9] ``autotune`` over backend x schedule x P x dedup at nell1 scale
    0.01; ``measure`` is the median CUDA-event ms of ``MEASURE_REPS``
    ``all_modes`` rotations (after a warm-up rotation) of
    ``make_engine(coo, spec, cache=cache)``. The hill-climb starts at the
    modeled pick, whose modeled cost must not exceed the default's."""
    import torch
    from repro_torch import engine
    from repro_torch.core import init_factors
    from repro_torch.engine import PlanSpace, PlanSpec, autotune, \
        make_engine

    factors = init_factors(torch.Generator(device="cuda").manual_seed(3),
                           coo[2], RANK)

    def measure(spec):
        state = make_engine(coo, spec, cache=cache)
        return cuda_median_ms(lambda: engine.all_modes(state, factors),
                              MEASURE_REPS)

    space = PlanSpace(backend=("cuda_fused", "cuda"),
                      schedule=("compact", "rect"), block_p=(64, 128, 256),
                      dedup=(True, False),
                      base=PlanSpec(backend="cuda_fused", rank_hint=RANK))
    t0 = time.perf_counter()
    res = autotune(*coo, space, measure=measure, cache=cache, seed=0)
    tune_s = time.perf_counter() - t0

    def name(s):
        return (f"{s.backend}/{s.schedule}/P{s.block_p}"
                + ("" if s.dedup else "/nodedup"))

    pick = res.trace[0]["spec"]
    if res.modeled[pick] > res.modeled[res.default]:
        raise AssertionError(f"modeled pick {name(pick)} "
                             f"{res.modeled[pick]} > default "
                             f"{res.modeled[res.default]}")
    top = sorted(res.analytic.items(), key=lambda kv: kv[1])
    log(f"[9] autotune: space {len(res.analytic)} specs, {tune_s:.1f} s, "
        f"cache {cache.stats()}")
    log("[9] analytic top 4: " + "; ".join(
        f"{name(s)} {c:.4g}" for s, c in top[:4]))
    log("[9] modeled: " + "; ".join(
        f"{name(s)} {c:.4g}" for s, c in res.modeled.items()))
    log("[9] measured ms: " + "; ".join(
        f"{name(s)} {t:.3f}" for s, t in res.measured.items()))
    log("[9] hill climb: " + " | ".join(
        f"{st['step']}: {name(st['spec'])} {st['time']:.3f} ms "
        f"({st['move']})" for st in res.trace))
    log(f"[9] modeled pick {name(pick)} ({res.modeled[pick]:.4g} <= default "
        f"{name(res.default)} {res.modeled[res.default]:.4g}); measured "
        f"pick {name(res.best)} (modeled {res.modeled[res.best]:.4g})")
    report["autotune"] = {
        "space": len(res.analytic), "seconds": tune_s,
        "analytic_top": [(name(s), c) for s, c in top[:4]],
        "modeled": {name(s): c for s, c in res.modeled.items()},
        "measured_ms": {name(s): t for s, t in res.measured.items()},
        "trace": [(st["step"], name(st["spec"]), st["time"], st["move"])
                  for st in res.trace],
        "modeled_pick": name(pick), "measured_pick": name(res.best),
        "default": name(res.default)}


# --------------------------------------------------------------------------
# RWKV-6: [2c] and [10].
# --------------------------------------------------------------------------
WKV_SHAPES = ((2, 16, 8, 8), (4, 32, 16, 32), (1, 64, 64, 64),
              (160, 256, 64, 64), (161, 4097, 64, 64))
# the backward kernel's (K = V = 64 only): ragged chunks, the model's rows
# (T >= 2: the dropped-carry variant zeroes w at step T / 2 >= 1)
WKV_BWD_SHAPES = ((3, 37, 64, 64), (160, 256, 64, 64))
RWKV_ARCH = "rwkv6-3b"
RWKV_BATCH, RWKV_SEQ = 4, 4096        # prefill_32k cut 8x in B and in S
WB_LORA_STD = 0.15                     # wb_lora is zero at init


def wkv_case(bh, t, k, v, seed):
    """The reference kernel tests' inputs: normal r, k, v, u; w uniform in
    [0.5, 0.999]."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    r, kk, vv = (torch.randn(s, generator=g, device="cuda")
                 for s in ((bh, t, k), (bh, t, k), (bh, t, v)))
    w = 0.5 + 0.499 * torch.rand((bh, t, k), generator=g, device="cuda")
    u = torch.randn((bh, k), generator=g, device="cuda")
    return r, kk, w, vv, u


def wkv_limit(kw6, args, sides=2):
    """Per-element limit of a float32 ``wkv6`` (see the module
    docstring)."""
    import torch

    a = kw6.wkv6_scan(*(x.double().abs() for x in args))
    t = torch.arange(a.shape[1], device=a.device, dtype=torch.float64)
    steps = 2 * (t + 1).sqrt()[None, :, None]
    return sides * LAMBDA * (steps + args[0].shape[-1] ** 0.5 + 3) * U * a


def wkv_check(kw6, args, tag):
    """Kernel against plain within the limit, and the limit against
    itself; returns (max error, its share of the limit)."""
    import torch

    r, k, w, v, u = args
    want = kw6.wkv6_plain(*args)
    lim = wkv_limit(kw6, args)
    res = close_to(f"{tag} wkv6", kw6.wkv6(*args), want, lim)
    late = torch.cat([w[:, :1], w[:, :-1]], dim=1).contiguous()
    kd = r.shape[-1]
    lane0 = (kw6.slices(kd, kw6.kernel_groups(kd)) == 0).to(r.device)
    no_lane = torch.where(lane0, 0.0, r)
    for variant, bad in (("u = 0", (r, k, w, v, torch.zeros_like(u))),
                         ("w_{t-1}", (r, k, late, v, u)),
                         ("r = 0 in one K-slice", (no_lane, k, w, v, u))):
        if not ((kw6.wkv6(*bad).double() - want.double()).abs() > lim).any():
            raise AssertionError(f"{tag} wkv6: the limit does not catch "
                                 f"the {variant} variant")
    return res


def phase_wkv6(kw6):
    """[2c] ``wkv6`` against its plain version at the reference kernel
    tests' shapes and at the model's rows."""
    import torch

    for i, shape in enumerate(WKV_SHAPES):
        err, share = wkv_check(kw6, wkv_case(*shape, seed=i), "[2c]")
        torch.cuda.synchronize()
        log(f"[2c] wkv6 (BH, T, K, V) = {shape} == plain (max err "
            f"{err:.3e}, {share:.3f} of the limit); u = 0, w_(t-1) and "
            "one-K-slice variants fail it")
    for i, shape in enumerate(WKV_BWD_SHAPES):
        args = wkv_case(*shape, seed=100 + i)
        dy = torch.randn(args[3].shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(i))
        err, share = wkv_bwd_check(kw6, args, dy, "[2c]")
        torch.cuda.synchronize()
        log(f"[2c] wkv6_bwd (BH, T, K, V) = {shape} == float64 plain (max "
            f"err {err:.3e}, {share:.3f} of the limit); a carry dropped at "
            "T / 2 fails it")


def wkv_bound(args):
    """``(bytes, flops)`` the WKV function must move and do
    (``kernels.wkv6.wkv6_cost``, which the dry-run charges too)."""
    from repro_torch.kernels import wkv6 as kw6

    r, _, _, v, _ = args
    return kw6.wkv6_cost(*r.shape, v.shape[-1])


def device_breakdown(fn, kernel="wkv6"):
    """Device time of one call of ``fn`` by kernel class, from
    ``torch.profiler``: ms in ``kernel`` (the port's kernel on the path;
    or a tuple of names, each kernel counted under the first it
    contains; or a dict of labels to tuples of name fragments, each
    kernel counted under the first label one of whose fragments it
    contains), in matrix products (cuBLAS, CUTLASS and nvjet kernels) and
    in all other kernels, the number of
    kernels, the host's wall ms (call + synchronize) and the device's
    busy share of it; ``None`` for the device numbers if the profiler
    saw no device time (then they are not measured)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    names = ({kernel: (kernel,)} if isinstance(kernel, str) else kernel
             if isinstance(kernel, dict) else {k: (k,) for k in kernel})
    ms = {**{k: 0.0 for k in names}, "matmul": 0.0, "other": 0.0}
    top, n = [], 0
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        t = e.device_time_total / 1e3
        name = e.key.lower()
        kind = next((k for k, frags in names.items()
                     if any(f in name for f in frags)), None) or (
            "matmul" if any(w in name for w in ("gemm", "xmma", "nvjet",
                                                "cutlass")) else "other")
        ms[kind] += t
        n += e.count
        top.append((t, e.count, e.key[:90]))
    busy = sum(ms.values())
    top.sort(reverse=True)
    return {"wall_ms": wall, "kernels": n,
            "device_ms": ms if busy else None,
            "busy_share": busy / wall if busy else None,
            "top": [{"ms": t, "count": c, "name": k} for t, c, k in top[:8]]}


def breakdown_line(b):
    if b["device_ms"] is None:
        return (f"wall {b['wall_ms']:.1f} ms; the profiler saw no device "
                "time (device split not measured)")
    split = ", ".join(f"{k} {v:.1f}" for k, v in b["device_ms"].items())
    return (f"wall {b['wall_ms']:.1f} ms, {b['kernels']} kernels, device "
            f"busy {b['busy_share']:.1%}: {split} ms")


def free_device_memory():
    """Collect reference cycles, then return the freed blocks to the card.
    A cycle through ``torch.profiler``'s frames keeps the profiled call's
    frames, and with them its model, alive after the phase returns."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()


GRAPH_TIMED_STEPS = 8          # replays timed with CUDA events a serving


def graph_gate(tag, model, cfg, scfg, prompt, toks, logits, enc=None):
    """The graph ``Engine``'s greedy tokens ``toks`` from ``prompt`` (one
    captured ``decode_step`` replayed, on the bf16 working copies of
    ``transformer.decode_working_copies``) and its logits after the last,
    held bitwise to the eager ``decode_step`` loop on the float32 masters
    (``Engine(graph=False, working_copies=False)``: the path before the
    graph) on caches of the same size ``scfg`` (another size reduces the
    attention in another order); an encoder-decoder's engine takes the
    frames ``enc``."""
    import torch
    from repro_torch.serving import Engine

    n = toks.shape[1]
    eng = Engine(model, cfg, scfg, device="cuda", enc_embeds=enc,
                 graph=False, working_copies=False)
    et, el = eng.generate(prompt, n), eng.last_logits
    if not (torch.equal(toks, et) and torch.equal(logits, el)):
        raise AssertionError(
            f"{tag} graph Engine vs the eager loop on the f32 masters: "
            f"tokens equal {torch.equal(toks, et)}, last logits max |diff| "
            f"{float((logits.float() - el.float()).abs().max()):.3e}")
    log(f"{tag} {cfg.compute_dtype}: {n} greedy tokens and the last logits "
        "of the graph Engine (working copies) == the eager decode_step "
        "loop on the f32 masters, bitwise")


def xcheck(tag, model4, cfg4, prompt, enc=None):
    """The float32 cross-check (module docstring): ``forward(prompt)[:,
    -1]`` against ``Engine.prefill(prompt)``, then 8 greedy tokens of
    ``Engine.generate`` from the first 16 against ``forward``'s; an
    encoder-decoder's forward and engines take the frames ``enc``. On
    the card both engines replay their captured step; the graph gate
    (:func:`graph_gate`) holds the graph engine to the eager loop.
    Returns (max |diff|, max |logit|)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.serving import Engine, ServeConfig

    batch, n = prompt.shape
    vocab = cfg4.vocab
    fl = transformer.forward(model4, cfg4, prompt,
                             enc_embeds=enc)[:, -1].float()
    pl = Engine(model4, cfg4, ServeConfig(batch, 2 * n), device="cuda",
                enc_embeds=enc).prefill(prompt)[:, -1].float()
    xerr = float((fl - pl).abs().max())
    if not xerr <= XCHECK_ATOL:
        raise AssertionError(f"{tag} f32 forward vs Engine.prefill: max "
                             f"|diff| {xerr:.3e} > {XCHECK_ATOL}")
    if not torch.equal(fl[:, :vocab].argmax(-1), pl[:, :vocab].argmax(-1)):
        raise AssertionError(f"{tag} f32 forward and Engine.prefill pick "
                             "different greedy tokens")
    seq = prompt[:, :16]
    scfg = ServeConfig(batch, 64)
    eng = Engine(model4, cfg4, scfg, device="cuda", enc_embeds=enc)
    toks = eng.generate(seq, 8)
    graph_gate(tag, model4, cfg4, scfg, seq, toks, eng.last_logits, enc)
    del eng
    for _ in range(8):
        nxt = transformer.forward(model4, cfg4, seq,
                                  enc_embeds=enc)[:, -1, :vocab]
        seq = torch.cat([seq, nxt.argmax(-1)[:, None]], dim=1)
    if not torch.equal(toks, seq[:, 16:]):
        raise AssertionError(f"{tag} greedy tokens of Engine.generate and "
                             "of forward differ")
    xlogit = float(fl.abs().max())
    log(f"{tag} f32, 4 layers {transformer.layer_kinds(cfg4)}: "
        f"forward(prompt)[:, -1] == Engine.prefill (S {n}, max |diff| "
        f"{xerr:.3e} <= {XCHECK_ATOL}, max |logit| {xlogit:.2f}); 8 greedy "
        "tokens of Engine.generate == forward's")
    return xerr, xlogit


def serve_check(tag, model, cfg, batch, g, kernel, enc=None):
    """Serving at full depth, bf16: ``batch`` requests of 16 prompt + 32
    new tokens, greedy, on the graph ``Engine`` (bf16 working copies; its
    first step eager, then the capture; an encoder-decoder's engine
    encodes the frames ``enc`` first) and on the eager engine on the
    float32 masters (the path before the graph: a cast of every weight a
    step); the graph's 32 tokens and last logits held bitwise to the
    eager engine's (:func:`graph_gate`'s check); then on each engine
    ``GRAPH_TIMED_STEPS`` more steps timed with CUDA events and one under
    ``torch.profiler`` (kernels a step, device busy share). Caches hold
    the 48 positions, the timed steps and their warm-up, and the profiled
    step (``Engine.step`` refuses one past a causal cache's end)."""
    import torch
    from repro_torch.serving import Engine, ServeConfig

    prompt = torch.randint(0, cfg.vocab, (batch, 16), generator=g,
                           device="cuda")
    scfg = ServeConfig(batch, 16 + 32 + GRAPH_TIMED_STEPS + 2)
    serve, out = [], []
    for graph in (True, False):
        free_device_memory()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = Engine(model, cfg, scfg, device="cuda", enc_embeds=enc,
                     graph=graph, working_copies=graph)
        torch.cuda.synchronize()
        encode_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        toks = eng.generate(prompt, 32)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if toks.shape != (batch, 32) or not (
                (toks >= 0) & (toks < cfg.vocab)).all():
            raise AssertionError(f"{tag} generate gave {tuple(toks.shape)} "
                                 "or tokens out of the vocabulary")
        out.append((toks, eng.last_logits))
        run = {"graph": graph, "seconds": dt,
               "tokens_per_s": batch * 32 / dt,
               "ms_per_step": 1e3 * dt / (16 + 32)}
        if enc is not None:
            run["encode_s"] = encode_s
        tok = toks[:, -1:]
        with torch.no_grad():
            run["step_ms"] = cuda_ms(lambda: eng.step(tok),
                                     GRAPH_TIMED_STEPS)
            prof = device_breakdown(lambda: eng.step(tok), kernel)
        run["steady_tokens_per_s"] = 1e3 * batch / run["step_ms"]
        run["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        run["step_profile"] = prof
        # the profiler's own start and sync stretch its wall time: the
        # busy share is the profiled device time over the step's CUDA-event
        # time
        busy = (sum(prof["device_ms"].values()) if prof["device_ms"]
                else None)
        run["busy_share"] = None if busy is None else busy / run["step_ms"]
        run["host_launches_per_step"] = (2 if graph else prof["kernels"])
        serve.append(run)
        del eng
    (gt, gl), (et, el) = out
    if not (torch.equal(gt, et) and torch.equal(gl, el)):
        raise AssertionError(
            f"{tag} graph Engine vs the eager loop on the f32 masters: "
            f"tokens equal {torch.equal(gt, et)}, last logits max |diff| "
            f"{float((gl.float() - el.float()).abs().max()):.3e}")
    del out, gt, gl, et, el
    gr, ea = serve
    speed = ea["step_ms"] / gr["step_ms"]

    def busy(run):
        share = run["busy_share"]
        return "not measured" if share is None else f"{share:.1%}"

    log(f"{tag} Engine.generate ({batch} requests, 16 prompt + 32 new "
        f"tokens, greedy, bf16): graph, bf16 working copies: "
        f"{gr['seconds']:.2f} s = {gr['tokens_per_s']:.1f} tokens/s with "
        f"the eager first step and the capture; a replay "
        f"{gr['step_ms']:.3f} ms (CUDA events, {GRAPH_TIMED_STEPS} "
        f"replays) = {gr['steady_tokens_per_s']:.1f} tokens/s; eager on "
        f"the f32 masters {ea['seconds']:.2f} s = "
        f"{ea['tokens_per_s']:.1f} tokens/s, a step {ea['step_ms']:.3f} "
        f"ms; graph {speed:.2f}x; peak {gr['peak_gib']:.2f} GiB with the "
        f"working copies, {ea['peak_gib']:.2f} GiB eager; 32 tokens and "
        "the last logits of the two engines bitwise equal" + (
            "" if enc is None else
            f"; the engine's encoder and cross caches over "
            f"{tuple(enc.shape)} frames first: {gr['encode_s']:.3f} s"))
    log(f"{tag} one replay's profile: {breakdown_line(gr['step_profile'])}"
        f"; device busy {busy(gr)} of the replay's CUDA-event time; host "
        "launches a step: 2 (the token copy and the replay)")
    log(f"{tag} one eager step's profile: "
        f"{breakdown_line(ea['step_profile'])}; device busy {busy(ea)} of "
        "its CUDA-event time")
    return {"serve": serve, "decode_step_profile": gr["step_profile"],
            "eager_step_profile": ea["step_profile"],
            "graph_speedup": speed}


def rwkv_model(cfg, seed):
    """The port's own init on the card from ``seed``, with ``wb_lora``
    drawn non-zero (a seeded generator on the card) so the decay varies
    per step and per channel."""
    import torch
    from repro_torch.models import transformer

    model = transformer.init_model(cfg, seed, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(seed + 1)
    for layer in model.layers:
        layer.wb_lora.normal_(0.0, WB_LORA_STD, generator=g)
    return model


def phase_rwkv(kw6, report, reps):
    """[10] RWKV-6 at the full width of ``rwkv6-3b``: prefill ``forward``
    (the main path of ``wkv6``), the kernel at layer 0's inputs, the
    float32 cross-check, and ``Engine.generate``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv, transformer
    from repro_torch.models.common import apply_norm

    cfg = get_config(RWKV_ARCH)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = rwkv_model(cfg, 0)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    gb = sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9
    log(f"[10] {RWKV_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"d_ff {cfg.d_ff}, vocab {cfg.vocab}; {n_params:,} params ({gb:.2f} "
        f"GB) initialised in {time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (RWKV_BATCH, RWKV_SEQ), generator=g,
                           device="cuda")
    out = {"params": n_params, "batch": RWKV_BATCH, "seq": RWKV_SEQ}

    # The main path: one prefill forward, bf16.
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        kw6.reset_launch_counts()
        logits = transformer.forward(model, cfg, tokens)
        torch.cuda.synchronize()
        out["prefill_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        launches = kw6.LAUNCHES["wkv6"]
        if launches != cfg.n_layers:
            raise AssertionError(f"[10] forward launched wkv6 {launches} "
                                 f"times, expected {cfg.n_layers}")
        if logits.shape != (RWKV_BATCH, RWKV_SEQ, cfg.vocab_padded) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"[10] forward logits {tuple(logits.shape)}"
                                 " not finite or of the wrong shape")
        del logits
        out["forward_ms"] = cuda_ms(
            lambda: transformer.forward(model, cfg, tokens), 2)
        log(f"[10] forward (B {RWKV_BATCH}, S {RWKV_SEQ}, bf16): "
            f"{out['forward_ms']:.1f} ms, wkv6 launches {launches}, peak "
            f"{out['prefill_peak_gib']:.2f} GiB")
        out["forward_profile"] = device_breakdown(
            lambda: transformer.forward(model, cfg, tokens))
        log(f"[10] forward profile: {breakdown_line(out['forward_profile'])}")

        # The kernel at layer 0's inputs, full shape.
        x0 = apply_norm(model.layers[0].ln1,
                        transformer.embed_lookup(model, tokens, cfg), cfg)
        args = rwkv.wkv_inputs(model.layers[0], x0, cfg)[:5]
        del x0
        err, share = wkv_check(kw6, args, "[10] layer 0")
        nbytes, flops = wkv_bound(args)
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, \
            1e3 * flops / F32_FLOP_PER_S
        wkv = {"ms": cuda_ms(lambda: kw6.wkv6(*args), reps),
               "plain_ms": cuda_ms(lambda: kw6.wkv6_plain(*args), 1),
               "bytes": nbytes, "flops": flops,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "max_abs_err": err, "launches": launches,
               "decay_range": [float(args[2].min()), float(args[2].max())]}
        del args
        log(f"[10] wkv6 at layer 0 (BH {RWKV_BATCH * rwkv.n_heads(cfg)}, T "
            f"{RWKV_SEQ}, 64, 64) == plain (max err {err:.3e}, {share:.3f} "
            f"of the limit; decay in [{wkv['decay_range'][0]:.5f}, "
            f"{wkv['decay_range'][1]:.5f}]): {wkv['ms']:.3f} ms a launch "
            f"(plain {wkv['plain_ms']:.1f}, bound {wkv['bound_ms']:.4f} by "
            f"{wkv['bound_by']})")

        # float32 cross-check: the kernel path against the decode path.
        cfg4 = dataclasses.replace(cfg, n_layers=4, compute_dtype="float32")
        model4 = rwkv_model(cfg4, 3)
        prompt = torch.randint(0, cfg.vocab, (RWKV_BATCH, 128), generator=g,
                               device="cuda")
        xerr, xlogit = xcheck("[10]", model4, cfg4, prompt)
        out["xcheck_max_abs_diff"] = xerr
        out["xcheck_max_abs_logit"] = xlogit
        del model4

    out.update(serve_check("[10]", model, cfg, RWKV_BATCH, g, "wkv6"))
    report["rwkv"] = {**out, "wkv6": wkv}
    del model
    free_device_memory()
    return wkv


def wkv6_record(wkv):
    """The ``wkv6`` entry of the ``kernels`` JSON line: one launch at
    layer 0's inputs of the prefill forward."""
    return {
        "name": "wkv6", "route": "cuda", "source": SOURCES["wkv6"],
        "replaces": REPLACES["wkv6"], "launches": wkv["launches"],
        "max_abs_err": wkv["max_abs_err"], "ms": wkv["ms"],
        "plain_ms": wkv["plain_ms"], "bound_ms": wkv["bound_ms"],
        "bound_by": wkv["bound_by"], "library_ms": None,
        "per": f"one launch at layer 0 of the {RWKV_ARCH} prefill forward "
               f"(B {RWKV_BATCH}, S {RWKV_SEQ}), which launches it once a "
               "layer; library_ms null: no single PyTorch call computes WKV",
    }


# --------------------------------------------------------------------------
# RecurrentGemma: [2d] and [11].
# --------------------------------------------------------------------------
LRU_SHAPES = ((1, 32, 8), (2, 64, 16), (3, 128, 32), (2, 64, 128))
LRU_MORE = ((3, 1000, 4100), (4, 256, 4096))   # ragged; the model's rows
RG_ARCH = "recurrentgemma-9b"
RG_BATCH, RG_SEQ = 4, 4096            # prefill_32k cut 8x in B and in S
RG_XCHECK_SEQ = 64


def lru_case(b, t, d, seed, dtype):
    """The reference kernel test's inputs: a uniform in [0.3, 0.999], x
    normal, in ``dtype``."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    a = 0.3 + 0.699 * torch.rand((b, t, d), generator=g, device="cuda")
    x = torch.randn((b, t, d), generator=g, device="cuda")
    return a.to(dtype), x.to(dtype)


def lru_limit(klru, a, x, sides=2):
    """Per-element limit of a float32 ``lru_scan`` (see the module
    docstring)."""
    import torch

    big_a = klru.lru_scan_steps(a.double().abs(), x.double().abs())
    t = torch.arange(a.shape[1], device=a.device, dtype=torch.float64)
    return sides * LAMBDA * 2 * (t + 1).sqrt()[None, :, None] * U * big_a


def lru_check(klru, a, x, tag):
    """Kernel against plain within the limit, and the limit against
    itself; returns (max error, its share of the limit)."""
    import torch

    want = klru.lru_scan_plain(a, x)
    lim = lru_limit(klru, a, x)
    res = close_to(f"{tag} lru_scan", klru.lru_scan(a, x), want, lim)
    t = a.shape[1]
    tb = klru.STEPS if t > klru.STEPS else t // 2
    late = torch.cat([a[:, :1], a[:, :-1]], dim=1)
    dropped = a.clone()
    dropped[:, tb] = 0
    for variant, bad in (("a_(t-1)", late), (f"a = 0 at t = {tb}", dropped)):
        got = klru.lru_scan(bad, x)
        if not ((got.double() - want.double()).abs() > lim).any():
            raise AssertionError(f"{tag} lru_scan: the limit does not "
                                 f"catch the {variant} variant")
    return res


def phase_lru(klru):
    """[2d] ``lru_scan`` against its plain version at the reference
    kernel tests' shapes (float32 and float16 inputs), a ragged shape and
    the model's rows."""
    import torch

    cases = [(s, dt) for s in LRU_SHAPES
             for dt in (torch.float32, torch.float16)]
    cases += [(s, torch.float32) for s in LRU_MORE]
    for i, (shape, dt) in enumerate(cases):
        err, share = lru_check(klru, *lru_case(*shape, seed=i, dtype=dt),
                               "[2d]")
        torch.cuda.synchronize()
        log(f"[2d] lru_scan (B, T, D) = {shape} {str(dt)[6:]} == plain (max "
            f"err {err:.3e}, {share:.3f} of the limit); a_(t-1) and "
            "dropped-carry variants fail it")
    for i, shape in enumerate(LRU_SHAPES + LRU_MORE[:1]):
        a, x = lru_case(*shape, seed=50 + i, dtype=torch.float32)
        with torch.no_grad():
            h = klru.lru_scan(a, x)
        dh = torch.randn(a.shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(i))
        err, share = lru_bwd_check(klru, a, h, dh, "[2d]")
        torch.cuda.synchronize()
        log(f"[2d] lru_scan_bwd (B, T, D) = {shape} == float64 plain (max "
            f"err {err:.3e}, {share:.3f} of the limit); a dropped carry "
            "fails it")


def phase_rg(klru, report, reps):
    """[11] RecurrentGemma at the full width and depth of
    ``recurrentgemma-9b``: prefill ``forward`` (the main path of
    ``lru_scan``), the kernel at layer 0's inputs, the float32
    cross-check, and ``Engine.generate``."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import rglru, transformer
    from repro_torch.models.common import apply_norm

    cfg = get_config(RG_ARCH)
    kinds = transformer.layer_kinds(cfg)
    n_rec = kinds.count("rec")
    free_device_memory()
    left = torch.cuda.memory_allocated() / 2**30
    t0 = time.perf_counter()
    model = transformer.init_model(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    gib = sum(p.numel() * p.element_size()
              for p in model.parameters()) / 2**30
    log(f"[11] {RG_ARCH}: {cfg.n_layers} layers ({n_rec} rec, "
        f"{kinds.count('local')} local, window {cfg.window}), d "
        f"{cfg.d_model}, lru_width {cfg.lru_width}, {cfg.n_heads} heads of "
        f"{cfg.hd} / {cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}; {n_params:,} params ({gib:.2f} GiB) initialised in "
        f"{time.perf_counter() - t0:.1f} s ({left:.2f} GiB left allocated "
        "by the earlier phases)")
    g = torch.Generator(device="cuda").manual_seed(2)
    tokens = torch.randint(0, cfg.vocab, (RG_BATCH, RG_SEQ), generator=g,
                           device="cuda")
    out = {"params": n_params, "layers": cfg.n_layers, "rec_layers": n_rec,
           "batch": RG_BATCH, "seq": RG_SEQ}

    # The main path: one prefill forward, bf16.
    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        klru.reset_launch_counts()
        logits = transformer.forward(model, cfg, tokens)
        torch.cuda.synchronize()
        out["prefill_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        launches = klru.LAUNCHES["lru_scan"]
        if launches != n_rec:
            raise AssertionError(f"[11] forward launched lru_scan "
                                 f"{launches} times, expected {n_rec}")
        if logits.shape != (RG_BATCH, RG_SEQ, cfg.vocab_padded) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"[11] forward logits {tuple(logits.shape)}"
                                 " not finite or of the wrong shape")
        del logits
        out["forward_ms"] = cuda_ms(
            lambda: transformer.forward(model, cfg, tokens), 2)
        log(f"[11] forward (B {RG_BATCH}, S {RG_SEQ}, bf16): "
            f"{out['forward_ms']:.1f} ms, lru_scan launches {launches}, "
            f"peak {out['prefill_peak_gib']:.2f} GiB")
        out["forward_profile"] = device_breakdown(
            lambda: transformer.forward(model, cfg, tokens), "lru_scan")
        log(f"[11] forward profile: {breakdown_line(out['forward_profile'])}")

        # The kernel at layer 0's inputs, full shape.
        layer0 = model.layers[0]
        x0 = apply_norm(layer0.ln1,
                        transformer.embed_lookup(model, tokens, cfg), cfg)
        a, b, _ = rglru.scan_inputs(layer0.rec, x0, cfg)
        del x0
        err, share = lru_check(klru, a, b, "[11] layer 0")
        nbytes, flops = klru.lru_scan_cost(*a.shape)
        bytes_ms, ops_ms = 1e3 * nbytes / HBM_BYTES_PER_S, \
            1e3 * flops / F32_FLOP_PER_S
        lru = {"ms": cuda_ms(lambda: klru.lru_scan(a, b), reps),
               "plain_ms": cuda_ms(lambda: klru.lru_scan_plain(a, b), 1),
               "bytes": nbytes, "flops": flops,
               "bound_ms": max(bytes_ms, ops_ms),
               "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
               "max_abs_err": err, "launches": launches,
               "a_range": [float(a.min()), float(a.max())]}
        del a, b
        log(f"[11] lru_scan at layer 0 (B {RG_BATCH}, T {RG_SEQ}, D "
            f"{cfg.lru_width}) == plain (max err {err:.3e}, {share:.3f} of "
            f"the limit; a in [{lru['a_range'][0]:.5f}, "
            f"{lru['a_range'][1]:.5f}]): {lru['ms']:.3f} ms a launch (plain "
            f"{lru['plain_ms']:.1f}, bound {lru['bound_ms']:.4f} by "
            f"{lru['bound_by']})")

        # float32 cross-check at 4 layers, over the same parameter tensors.
        cfg4 = dataclasses.replace(cfg, n_layers=4, compute_dtype="float32")
        model4 = first_layers(model, cfg4)
        prompt = torch.randint(0, cfg.vocab, (RG_BATCH, RG_XCHECK_SEQ),
                               generator=g, device="cuda")
        xerr, xlogit = xcheck("[11]", model4, cfg4, prompt)
        out["xcheck_max_abs_diff"] = xerr
        out["xcheck_max_abs_logit"] = xlogit
        del model4

    out.update(serve_check("[11]", model, cfg, RG_BATCH, g, "lru_scan"))
    report["recurrentgemma"] = {**out, "lru_scan": lru}
    del model
    free_device_memory()
    return lru


def lru_scan_record(lru):
    """The ``lru_scan`` entry of the ``kernels`` JSON line: one launch at
    layer 0's inputs of the prefill forward."""
    return {
        "name": "lru_scan", "route": "cuda", "source": SOURCES["lru_scan"],
        "replaces": REPLACES["lru_scan"], "launches": lru["launches"],
        "max_abs_err": lru["max_abs_err"], "ms": lru["ms"],
        "plain_ms": lru["plain_ms"], "bound_ms": lru["bound_ms"],
        "bound_by": lru["bound_by"], "library_ms": None,
        "per": f"one launch at layer 0 of the {RG_ARCH} prefill forward "
               f"(B {RG_BATCH}, S {RG_SEQ}), which launches it once a rec "
               "layer; library_ms null: no single PyTorch call computes a "
               "linear recurrence",
    }


# --------------------------------------------------------------------------
# [12] The streaming tier.
# --------------------------------------------------------------------------
STREAM_LAYOUT = ("val", "idx", "alpha", "lrow")
STREAM_CHUNK = 1 << 20         # [12a]: chunk slots, ~10 chunks a mode
RECT_STREAM_CHUNK = 1 << 22    # [12b]: ~9 chunks a rect mode
VAST_SCALE = 0.125             # [12d]: the paper's vast tensor at an
#                                eighth of its scale, so the whole run
#                                with [17]-[19] stays inside its time
#                                limit on a slow host (ROADMAP)
VAST_REPS = 3                  # [12d]: timed rotations, median taken


def resident_rotation(t, cfg, factors):
    """One resident rotation, mode by mode: each mode's output and its
    layout (the first S_d slots, with ``lrow``) on the host."""
    from repro_torch import engine
    from repro_torch.engine.api import mode_layout

    st = engine.init(t, cfg)
    outs, lays = [None] * t.nmodes, [None] * t.nmodes
    for _ in range(t.nmodes):
        d = st.mode
        sd = st.statics[d].padded_nnz
        lay = mode_layout(st, (st.val, st.idx, st.alpha), d)
        lays[d] = {k: lay[k][:sd].cpu() for k in STREAM_LAYOUT}
        outs[d], st = engine.mttkrp(st, factors)
    return outs, lays


def host_layout(ss):
    """A copy of the streamed host layout of the resident mode."""
    import torch

    return {k: torch.from_numpy(getattr(ss, k).copy())
            for k in STREAM_LAYOUT}


def stream_model_bytes(ss):
    """The reference's budget model of this stream, ``stream_fixed_bytes
    + stream_ring x chunk_device_bytes`` of the largest chunk; and what
    it does not count that the port adds: the chunks' work tables and the
    largest chunk's partial tiles (``rows_pp x R`` floats each)."""
    from repro_torch.engine.stream import (chunk_device_bytes,
                                           stream_fixed_bytes)

    n = ss.nmodes
    model = (stream_fixed_bytes(ss.dims, ss.config, rank=RANK,
                                statics=ss.statics)
             + ss.config.stream_ring * max(
                 chunk_device_bytes(cs, n, ss.plan.tables)
                 for cs in ss.plan.chunks))
    extra = 0
    if ss.chunks[0][0].work is not None:
        tables = sum(4 * (ch.work.chunks.numel() + ch.work.wsum.numel())
                     for chs in ss.chunks for ch in chs)
        partials = max(ch.work.n_partials * ss.statics[d].rows_pp * RANK * 4
                       for d, chs in enumerate(ss.chunks) for ch in chs)
        extra = tables + partials
    return model, extra


def peak_of(fn):
    """``fn()``, and the device bytes allocated at most while it ran over
    those held before it."""
    import torch

    free_device_memory()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    return out, torch.cuda.max_memory_allocated() - held


def stream_check(kmt, tag, t, cfg, res_cfg, factors, oracle, names):
    """One streamed rotation of ``t`` under ``cfg`` (the launch counts set
    to 0 just before it and read just after; each of ``names`` must have
    launched): each mode against the oracle and against the resident
    engine's rotation under ``res_cfg`` (two-sided limit), the host layout
    before every mode bitwise the resident one, and back at its start
    after the rotation. Returns a row of numbers."""
    import torch
    from repro_torch.engine.stream import stream_init, stream_mttkrp

    n = t.nmodes
    res_outs, res_lays = resident_rotation(t, res_cfg, factors)
    torch.cuda.synchronize()

    def run():
        ss = stream_init(t, cfg)
        start = host_layout(ss)
        lays, outs = [None] * n, [None] * n
        kmt.reset_launch_counts()
        for _ in range(n):
            d = ss.mode
            lays[d] = host_layout(ss)
            outs[d], ss = stream_mttkrp(ss, factors)
        torch.cuda.synchronize()
        return ss, start, lays, outs, dict(kmt.LAUNCHES)

    t0 = time.perf_counter()
    (ss, start, lays, outs, launches), peak = peak_of(run)
    secs = time.perf_counter() - t0
    for name in names:
        if launches[name] == 0:
            raise AssertionError(f"{tag}: the stream never launched {name}")
    errs, shares, rshares = [], [], []
    for d in range(n):
        e, s = close_to(f"{tag} mode {d} vs mttkrp_ref", outs[d], *oracle[d])
        r = close_to(f"{tag} mode {d} vs resident", outs[d], res_outs[d],
                     2 * oracle[d][1])[1]
        errs.append(e)
        shares.append(s)
        rshares.append(r)
        for k in STREAM_LAYOUT:
            exact(f"{tag} mode {d} host layout {k}", lays[d][k],
                  res_lays[d][k])
    end = host_layout(ss)
    for k in STREAM_LAYOUT:
        exact(f"{tag} host layout {k} after rotation", end[k], start[k])
    model, extra = stream_model_bytes(ss)
    row = {"chunks": [cs.nchunks for cs in ss.plan.chunks],
           "target_slots": ss.plan.target_slots,
           "launches": {k: launches[k] for k in names},
           "max_err": max(errs), "max_share": max(shares),
           "resident_share": max(rshares), "peak_bytes": peak,
           "model_bytes": model, "unmodeled_bytes": extra,
           "seconds": secs, **ss.stats.as_row()}
    log(f"{tag}: chunks a mode {row['chunks']} (target {row['target_slots']}"
        f" slots); each mode == mttkrp_ref (max err {max(errs):.3e}, "
        f"{max(shares):.2e} of the limit) and == resident ("
        f"{max(rshares):.2e} of the two-sided limit); host layouts bitwise "
        f"the resident ones and back at the start; launches "
        f"{row['launches']}; overlap {ss.stats.overlap_efficiency:.3f}; "
        f"peak {peak / 2**30:.3f} GiB (model {model / 2**30:.3f} + "
        f"{extra / 2**30:.4f} GiB tables and partials); "
        f"{secs:.1f} s with set-up")
    return row


def shifted_chunk_mutant(t, cfg, factors, oracle):
    """The limit held against itself: the upload of chunk c reads chunk
    c - 1's slot range (what a missing event wait or a wrong offset
    returns); mode 0's output must fail the oracle limit."""
    from repro_torch.engine import stream

    orig = stream._chunk_span
    stream._chunk_span = lambda cs, c: orig(cs, max(c - 1, 0))
    try:
        out, _ = stream.stream_mttkrp(stream.stream_init(t, cfg), factors)
    finally:
        stream._chunk_span = orig
    try:
        close_to("shifted-chunk mutant", out, *oracle[0])
    except AssertionError as exc:
        return str(exc)
    raise AssertionError("a stream whose uploads read the previous chunk's "
                         "slots passed the oracle limit")


def phase_stream_nell1(kmt, t, factors, fits3, witness3, report):
    """[12a] nell1 scale 0.1 ([3]'s tensor and factors) streamed at
    ``chunk_nnz = STREAM_CHUNK``: ``cuda_fused`` and ``cuda``, compact; the
    shifted-chunk mutant; ``cp_als_stream`` against [3]'s fits and its
    float64 witness."""
    import torch
    from repro_torch.engine import ExecutionConfig
    from repro_torch.engine.stream import cp_als_stream

    oracle = mttkrp_oracle(torch.from_numpy(t.indices).cuda(),
                           torch.from_numpy(t.values).cuda(), factors,
                           t.dims)
    rows = {}
    for backend, name in (("cuda_fused", "mttkrp_fused_gather_compact"),
                          ("cuda", "mttkrp_fused_compact")):
        cfg = ExecutionConfig(backend=backend, rank_hint=RANK,
                              residency="stream", chunk_nnz=STREAM_CHUNK)
        res_cfg = ExecutionConfig(backend=backend, rank_hint=RANK)
        rows[backend] = stream_check(kmt, f"[12a] nell1 stream {backend}",
                                     t, cfg, res_cfg, factors, oracle,
                                     (name,))
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK,
                          residency="stream", chunk_nnz=STREAM_CHUNK)
    mutant = shifted_chunk_mutant(t, cfg, factors, oracle)
    log(f"[12a] shifted-chunk mutant fails the limit: {mutant}")
    fits = cp_als_stream(t, RANK, iters=3, config=cfg, factors=factors).fits
    f64 = witness3[0]["f64_fits"]
    gaps = (max(abs(a - b) for a, b in zip(fits, fits3)),
            max(abs(a - b) for a, b in zip(fits, f64)))
    if not all(f == f and abs(f) < 1e30 for f in fits) \
            or max(gaps) > FIT_ATOL:
        raise AssertionError(f"cp_als_stream fits {fits} vs resident "
                             f"{fits3}, float64 {f64}")
    log(f"[12a] cp_als_stream fits {fits} (resident {fits3}, max diff "
        f"{gaps[0]:.2e}; float64 witness {gaps[1]:.2e})")
    report["stream_nell1"] = {"rows": rows, "mutant": mutant, "fits": fits,
                              "fit_gaps": gaps}
    del oracle
    free_device_memory()


def phase_stream_rect(kmt, report):
    """[12b] nell1 scale 0.01 ([8]'s tensor), rect, streamed on
    ``cuda_fused`` (``mttkrp_fused_gather`` a chunk) beside the resident
    engine (``mttkrp_fused_remap``)."""
    import torch
    from repro_torch.core import PlanCache, init_factors, spec, synthesize
    from repro_torch.engine import ExecutionConfig
    from repro_torch.engine.api import as_flycoo

    ts = spec("nell1", scale=0.01)
    indices, values = synthesize(ts, seed=0)
    cfg = ExecutionConfig(backend="cuda_fused", schedule="rect",
                          rank_hint=RANK, residency="stream",
                          chunk_nnz=RECT_STREAM_CHUNK)
    t = as_flycoo((indices, values, ts.dims), cfg, PlanCache())
    factors = init_factors(torch.Generator(device="cuda").manual_seed(2),
                           ts.dims, RANK)
    oracle = mttkrp_oracle(torch.from_numpy(indices).cuda(),
                           torch.from_numpy(values).cuda(), factors, ts.dims)
    res_cfg = ExecutionConfig(backend="cuda_fused", schedule="rect",
                              rank_hint=RANK)
    report["stream_rect"] = stream_check(
        kmt, "[12b] nell1 0.01 rect stream cuda_fused", t, cfg, res_cfg,
        factors, oracle, ("mttkrp_fused_gather",))
    del oracle
    free_device_memory()


def phase_stream_twitch(kmt, report):
    """[12c] twitch scale 0.01 ([5]'s tensor, five modes) streamed on
    ``cuda_fused`` in at least 4 chunks a mode."""
    import torch
    from repro_torch.core import build_flycoo, init_factors, spec, synthesize
    from repro_torch.engine import ExecutionConfig

    ts = spec("twitch", scale=0.01)
    indices, values = synthesize(ts, seed=0)
    res_cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK)
    n = len(ts.dims)
    t = build_flycoo(indices, values, ts.dims,
                     kappa=[res_cfg.kappa_for(i, n) for i in ts.dims],
                     block_p=res_cfg.block_p)
    target = min(p.padded_nnz for p in t.plans) // 8
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK,
                          residency="stream", chunk_nnz=target)
    factors = init_factors(torch.Generator(device="cuda").manual_seed(1),
                           t.dims, RANK)
    oracle = mttkrp_oracle(torch.from_numpy(indices).cuda(),
                           torch.from_numpy(values).cuda(), factors, t.dims)
    row = stream_check(kmt, "[12c] twitch 0.01 stream cuda_fused", t, cfg,
                       res_cfg, factors, oracle,
                       ("mttkrp_fused_gather_compact",))
    if min(row["chunks"]) < 4:
        raise AssertionError(f"[12c] fewer than 4 chunks a mode: "
                             f"{row['chunks']}")
    report["stream_twitch"] = row
    del oracle
    free_device_memory()


def timed_rotation(ss, factors):
    """One ``stream_all_modes`` rotation: wall seconds, its upload ms
    (copy-stream events), kernel ms (compute-stream events around each
    chunk's kernels and its copy into the accumulator), host remap
    seconds and bytes uploaded."""
    import torch
    from repro_torch.engine.stream import stream_all_modes

    st = ss.stats
    st.timeline = []
    h2d, remap = st.h2d_bytes, st.host_remap_s
    t0 = time.perf_counter()
    outs, ss = stream_all_modes(ss, factors)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = {"upload": 0.0, "compute": 0.0}
    for kind, _, _, a, b in st.timeline:
        ms[kind] += a.elapsed_time(b)
    st.timeline = None
    return outs, ss, {"wall_s": wall, "upload_ms": ms["upload"],
                      "kernel_ms": ms["compute"],
                      "remap_s": st.host_remap_s - remap,
                      "h2d_bytes": st.h2d_bytes - h2d}


def phase_stream_vast(kmt, report):
    """[12d] the paper's vast tensor (Table 3: 165,400 x 11,400 x 2 x 100
    x 89, R = 32) through ``make_engine`` with ``residency="auto"`` and a
    budget of 1/8 of its resident footprint: it must resolve to the
    stream. Times the streamed rotation (one warm-up, the median of
    ``VAST_REPS``; upload, kernel and host remap apart) beside the
    resident one, holds its peak against the budget model's prediction
    and the resident peak. The last timed rotation runs with the launch
    counts set to 0 (one ``mttkrp_fused_gather_compact`` a chunk), and
    each of its five modes is held against the oracle and against the
    resident engine's rotation (two-sided limit); one ``cp_als_stream``
    sweep against a resident ``cp_als`` sweep from the same factors."""
    import statistics

    import torch
    from repro_torch import engine
    from repro_torch.core import (PlanCache, cp_als, init_factors, spec,
                                  synthesize)
    from repro_torch.engine import ExecutionConfig, PlanSpec, make_engine
    from repro_torch.engine.api import as_flycoo
    from repro_torch.engine.stream import (StreamState, cp_als_stream,
                                           resident_bytes,
                                           stream_transfer_model)

    name = "mttkrp_fused_gather_compact"
    t0 = time.perf_counter()
    ts = spec("vast", scale=VAST_SCALE)
    indices, values = synthesize(ts, seed=0)
    coo = (indices, values, ts.dims)
    synth_s = time.perf_counter() - t0
    cfg_full = ExecutionConfig(backend="cuda_fused", rank_hint=RANK)
    cache = PlanCache()
    t = as_flycoo(coo, cfg_full, cache)
    for d in range(t.nmodes):
        t.dedup_tables(d)
    resident = resident_bytes(t, cfg_full)
    budget = resident // 8
    spec_s = PlanSpec(backend="cuda_fused", rank_hint=RANK,
                      residency="auto", device_budget_bytes=budget)
    factors = init_factors(torch.Generator(device="cuda").manual_seed(3),
                           t.dims, RANK)
    plan_s = time.perf_counter() - t0 - synth_s

    def build_and_warm():
        t1 = time.perf_counter()
        ss = make_engine(coo, spec_s, cache=cache)
        if not isinstance(ss, StreamState):
            raise AssertionError(f"[12d] auto resolved to "
                                 f"{type(ss).__name__}, not the stream")
        init_s = time.perf_counter() - t1
        _, ss, warm = timed_rotation(ss, factors)
        return ss, init_s, warm

    (ss, init_s, warm), peak_s = peak_of(build_and_warm)
    host_s = synth_s + plan_s + init_s
    chunks = [cs.nchunks for cs in ss.plan.chunks]
    target = ss.plan.target_slots
    log(f"[12d] vast scale {VAST_SCALE}: dims {ts.dims} nnz {t.nnz}; host "
        f"set-up {host_s:.1f} s (synthesize {synth_s:.1f}, plans and dedup "
        f"tables {plan_s:.1f}, make_engine -> StreamState {init_s:.1f}); "
        f"resident_bytes {resident / 2**30:.3f} GiB, budget "
        f"{budget / 2**30:.3f} GiB; chunks a mode {chunks} (target "
        f"{target} slots)")
    rows = []
    for _ in range(VAST_REPS):
        kmt.reset_launch_counts()
        outs, ss, row = timed_rotation(ss, factors)
        rows.append(row)
    launches = kmt.LAUNCHES[name]
    if launches != ss.plan.total_chunks:
        raise AssertionError(f"[12d] {name} launched {launches} times in a "
                             f"rotation of {ss.plan.total_chunks} chunks")
    med = {k: statistics.median(r[k] for r in rows) for k in rows[0]}
    model = stream_transfer_model(t, ss.config)
    model_b, extra = stream_model_bytes(ss)
    overlap = ss.stats.overlap_efficiency
    gbs = med["h2d_bytes"] / med["upload_ms"] / 1e6
    log(f"[12d] streamed rotation, median of {VAST_REPS} (warm-up "
        f"{warm['wall_s']:.3f} s): wall {med['wall_s']:.3f} s; uploads "
        f"{med['upload_ms']:.1f} ms on the copy stream, kernels "
        f"{med['kernel_ms']:.1f} ms on the compute stream, host remap "
        f"{med['remap_s']:.3f} s; H2D {med['h2d_bytes'] / 1e9:.3f} GB "
        f"(model {model['h2d_bytes'] / 1e9:.3f} GB), {gbs:.1f} GB/s; "
        f"overlap {overlap:.3f}; {name} launches {launches} (last "
        "rotation); each rotation (wall / uploads / kernels / remap): "
        + "; ".join(f"{r['wall_s']:.3f} s / {r['upload_ms']:.1f} / "
                    f"{r['kernel_ms']:.1f} ms / {r['remap_s']:.3f} s"
                    for r in rows))
    if med["h2d_bytes"] > model["h2d_bytes"]:
        raise AssertionError("[12d] uploads exceed the transfer model")
    del ss
    free_device_memory()
    fit = cp_als_stream(t, RANK, iters=1, config=spec_s.to_config(),
                        factors=factors, cache=cache).fits
    free_device_memory()

    init_peak = []

    def resident_run():
        state = engine.init(t, cfg_full)
        torch.cuda.synchronize()
        init_peak.append(torch.cuda.max_memory_allocated())
        res_outs, _ = engine.all_modes(state, factors)
        return state, res_outs

    free_device_memory()
    held = torch.cuda.memory_allocated()
    (state, res_outs), peak_r = peak_of(resident_run)
    peak_init = init_peak[0] - held
    res_ms = cuda_median_ms(lambda: engine.all_modes(state, factors),
                            VAST_REPS)
    del state
    free_device_memory()
    res_fit = cp_als(t, RANK, iters=1, config=cfg_full,
                     factors=factors).fits
    fit_gap = abs(fit[0] - res_fit[0])
    if not all(f == f and abs(f) < 1e30 for f in fit) or fit_gap > FIT_ATOL:
        raise AssertionError(f"[12d] cp_als_stream fits {fit} vs resident "
                             f"{res_fit}")
    oracle = mttkrp_oracle(torch.from_numpy(indices).cuda(),
                           torch.from_numpy(values).cuda(), factors, t.dims)
    errs, shares, rshares = [], [], []
    for d in range(t.nmodes):
        e, s = close_to(f"[12d] vast mode {d} stream vs mttkrp_ref",
                        outs[d], *oracle[d])
        r = close_to(f"[12d] vast mode {d} stream vs resident", outs[d],
                     res_outs[d], 2 * oracle[d][1])[1]
        errs.append(e)
        shares.append(s)
        rshares.append(r)
    oracle_h = [(w.cpu(), lim.cpu()) for w, lim in oracle]
    del oracle, outs, res_outs
    log(f"[12d] each mode streamed == mttkrp_ref (max err {max(errs):.3e}, "
        f"{max(shares):.2e} of the limit) and == resident "
        f"({max(rshares):.2e} of the two-sided limit); cp_als_stream 1 "
        f"sweep: fit {fit[0]:.6f} (resident cp_als {res_fit[0]:.6f}, diff "
        f"{fit_gap:.2e}); resident all_modes {res_ms:.2f} ms (median of "
        f"{VAST_REPS}); peak streamed {peak_s / 2**30:.3f} GiB (model "
        f"{model_b / 2**30:.3f} + {extra / 2**30:.4f} GiB tables and "
        f"partials; budget {budget / 2**30:.3f}), resident "
        f"{peak_r / 2**30:.3f} GiB (engine.init alone "
        f"{peak_init / 2**30:.3f})")
    if not peak_s < model_b + extra:
        raise AssertionError(f"[12d] streamed peak {peak_s} over the model "
                             f"{model_b} + {extra}")
    if not peak_s < peak_r:
        raise AssertionError(f"[12d] streamed peak {peak_s} not under the "
                             f"resident {peak_r}")
    report["stream_vast"] = {
        "scale": VAST_SCALE, "dims": ts.dims, "nnz": t.nnz,
        "host_s": host_s, "synth_s": synth_s, "plan_s": plan_s,
        "init_s": init_s, "resident_bytes": resident, "budget": budget,
        "chunks": chunks, "target_slots": target, "launches": {name: launches},
        "warm": warm, "rotations": rows, "median": med,
        "model_h2d_bytes": model["h2d_bytes"], "overlap": overlap,
        "h2d_gbs": gbs, "resident_ms": res_ms, "peak_stream": peak_s,
        "model_bytes": model_b, "unmodeled_bytes": extra,
        "peak_resident": peak_r, "peak_resident_init": peak_init,
        "max_err": max(errs),
        "max_share": max(shares), "resident_share": max(rshares),
        "cp_fit": fit, "resident_cp_fit": res_fit, "fit_gap": fit_gap}
    free_device_memory()
    return {"t": t, "cache": cache, "factors": factors,
            "oracle": oracle_h, "budget": budget, "peak_stream": peak_s,
            "peak_init": peak_init}


def phase_stream(kmt, t, factors, report):
    """[12] The streaming tier: [12a]-[12d]; returns [12d]'s vast tensor,
    factors and oracle for [13c]."""
    phase_stream_nell1(kmt, t, factors, report["nell1"]["fits"],
                       report["nell1"]["fit_witness"], report)
    phase_stream_rect(kmt, report)
    phase_stream_twitch(kmt, report)
    return phase_stream_vast(kmt, report)


# --------------------------------------------------------------------------
# [13] Resilience on the card.
# --------------------------------------------------------------------------
ALS_SCALE = 0.01               # [13a]: the kill-and-resume child's nell1
ALS_SWEEPS = 6
KILL_SWEEP = 3
OOM_CHUNK = 3                  # [13d]: the chunk compute that OOMs
RESILIENCE_ENV = ("REPRO_LADDER", "REPRO_CHAOS")


def resilience_counts():
    """Totals of the resilience counters on the port's registry:
    degradations, retries, recoveries and injected faults."""
    from repro_torch import obs

    return {name: obs.REGISTRY.counter(name).total()
            for name in ("resilience_degradations", "resilience_retries",
                         "resilience_recoveries", "chaos_injections")}


def als_child(ckpt, out, mode):
    """``--als-child``: ``cp_als`` on ``cuda_fused`` at nell1 scale
    ``ALS_SCALE``, ``ALS_SWEEPS`` sweeps, a snapshot every sweep into
    ``ckpt``; ``mode`` "resume" resumes from it. Writes the factors,
    lam and fits to ``out`` (npz), with the sweeps this process ran (from
    the ``cpd.sweep`` spans) and the snapshots it loaded."""
    import numpy as np
    import torch
    from repro_torch.core import build_flycoo, cp_als, init_factors, spec, \
        synthesize
    from repro_torch.engine import ExecutionConfig
    from repro_torch.obs import trace
    from repro_torch.resilience import SnapshotStore

    torch.backends.cuda.matmul.allow_tf32 = False
    ts = spec("nell1", scale=ALS_SCALE)
    indices, values = synthesize(ts, seed=0)
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK)
    n = len(ts.dims)
    t = build_flycoo(indices, values, ts.dims,
                     kappa=[cfg.kappa_for(i, n) for i in ts.dims],
                     block_p=cfg.block_p)
    factors = init_factors(torch.Generator(device="cuda").manual_seed(0),
                           t.dims, RANK)
    store = SnapshotStore(ckpt) if ckpt else None
    tracer = trace.enable()
    t0 = time.perf_counter()
    res = cp_als(t, RANK, iters=ALS_SWEEPS, config=cfg, factors=factors,
                 checkpoint=store, checkpoint_every=1,
                 resume=mode == "resume")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sweeps = [r.attrs["sweep"] for r in tracer.spans()
              if r.name == "cpd.sweep"]
    np.savez(out, *[f.cpu().numpy() for f in res.factors],
             lam=res.lam.cpu().numpy(), fits=np.asarray(res.fits),
             seconds=secs, sweeps=np.asarray(sweeps, np.int64),
             loads=store.loads if store is not None else 0)
    return 0


def run_children(jobs):
    """Run ``--als-child`` processes at once; ``jobs`` is a list of
    ``(ckpt, out, mode, chaos)``. Returns their return codes and
    standard errors, in order."""
    import os

    procs = []
    for ckpt, out, mode, chaos in jobs:
        env = {k: v for k, v in os.environ.items()
               if k not in RESILIENCE_ENV}
        if chaos:
            env["REPRO_CHAOS"] = chaos
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--als-child",
             ckpt, out, mode], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def npz_diff(a, b):
    """Largest |difference| of the factors and lam, and of the fits, of
    two child outputs; and whether they are bitwise equal."""
    import numpy as np

    names = [k for k in a.files if k not in ("seconds", "sweeps", "loads")]
    same = all(np.array_equal(a[k], b[k]) for k in names)
    fac = max(float(np.abs(a[k].astype(np.float64) - b[k]).max())
              for k in names if k != "fits")
    fits = float(np.abs(a["fits"] - b["fits"]).max())
    return same, fac, fits


def phase_kill_resume(report):
    """[13a] ``cp_als`` killed at the start of sweep ``KILL_SWEEP`` by the
    ``kill_sweep`` fault, then resumed from its snapshots, in child
    processes: two clean runs (is the card run-to-run bitwise?), the
    killed run (must die of SIGKILL, leaving snapshots), the resumed run
    (bitwise the clean one if the card is, else within ``FIT_ATOL``)."""
    import os
    import signal
    import tempfile

    import numpy as np
    from repro_torch.resilience import SnapshotStore

    with tempfile.TemporaryDirectory() as tmp:
        ck = os.path.join(tmp, "ckpt")
        out = {k: os.path.join(tmp, f"{k}.npz")
               for k in ("clean", "clean2", "resumed")}
        t0 = time.perf_counter()
        (rc_a, err_a), (rc_b, err_b), (rc_k, err_k) = run_children([
            ("", out["clean"], "fresh", None),
            ("", out["clean2"], "fresh", None),
            (ck, os.devnull, "fresh", f"kill_sweep={KILL_SWEEP}")])
        for rc, err in ((rc_a, err_a), (rc_b, err_b)):
            if rc != 0:
                raise AssertionError(f"[13a] clean child exited {rc}: "
                                     f"{err[-2000:]}")
        if rc_k != -signal.SIGKILL:
            raise AssertionError(f"[13a] killed child exited {rc_k}, not "
                                 f"-SIGKILL: {err_k[-2000:]}")
        left = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
        if not left:
            raise AssertionError("[13a] no snapshot survived the kill")
        # the newest snapshot the killed child left: the resumed child
        # must start from it
        store = SnapshotStore(ck)
        snap = max((store.load(os.path.join(ck, f)) for f in left),
                   key=lambda x: x.sweep)
        if snap.sweep != KILL_SWEEP:
            raise AssertionError(f"[13a] the killed child's newest snapshot "
                                 f"is at sweep {snap.sweep}, not "
                                 f"{KILL_SWEEP}")
        (rc_r, err_r), = run_children([(ck, out["resumed"], "resume",
                                        None)])
        if rc_r != 0:
            raise AssertionError(f"[13a] resumed child exited {rc_r}: "
                                 f"{err_r[-2000:]}")
        secs = time.perf_counter() - t0
        with np.load(out["clean"]) as a, np.load(out["clean2"]) as b, \
                np.load(out["resumed"]) as r:
            bitwise, cc_fac, cc_fit = npz_diff(a, b)
            same_r, rc_fac, rc_fit = npz_diff(a, r)
            fits, rfits = a["fits"].tolist(), r["fits"].tolist()
            child_s = [float(x["seconds"]) for x in (a, b, r)]
            ran = [x["sweeps"].tolist() for x in (a, b, r)]
            loads = [int(x["loads"]) for x in (a, b, r)]
            kept = np.array_equal(r["fits"][:KILL_SWEEP],
                                  np.asarray(snap.fits, np.float64))
    full = list(range(ALS_SWEEPS))
    if ran[:2] != [full, full] or ran[2] != full[KILL_SWEEP:] \
            or loads != [0, 0, 1]:
        raise AssertionError(f"[13a] sweeps run {ran} and snapshots "
                             f"loaded {loads} (clean, clean, resumed): the "
                             f"resumed child must load one snapshot and "
                             f"run only sweeps {full[KILL_SWEEP:]}")
    if not kept:
        raise AssertionError(f"[13a] the resumed fits {rfits} do not begin "
                             f"with the snapshot's {snap.fits} bitwise")
    if bitwise and not same_r:
        raise AssertionError("[13a] the card is run-to-run bitwise but the "
                             f"resumed run is not: fits {rfits} vs {fits}")
    if not all(f == f for f in rfits) or rc_fit > FIT_ATOL:
        raise AssertionError(f"[13a] resumed fits {rfits} vs clean {fits}")
    log(f"[13a] nell1 {ALS_SCALE} cp_als {ALS_SWEEPS} sweeps, killed at "
        f"sweep {KILL_SWEEP} (SIGKILL, snapshots left {left}) and resumed; "
        f"clean vs clean bitwise {bitwise} (factors {cc_fac:.3e}, fits "
        f"{cc_fit:.3e}); resumed vs clean bitwise {same_r} (factors "
        f"{rc_fac:.3e}, fits {rc_fit:.3e}); the resumed child loaded 1 "
        f"snapshot, ran sweeps {ran[2]} and kept the snapshot's "
        f"{KILL_SWEEP} fits bitwise; cp_als in the children "
        f"{child_s[0]:.2f} / {child_s[1]:.2f} / {child_s[2]:.2f} s "
        f"(clean, clean, resumed); {secs:.1f} s with the processes")
    report["kill_resume"] = {
        "bitwise_run_to_run": bitwise, "clean_clean_factor_diff": cc_fac,
        "clean_clean_fit_diff": cc_fit, "resumed_bitwise": same_r,
        "resumed_factor_diff": rc_fac, "resumed_fit_diff": rc_fit,
        "fits": fits, "resumed_fits": rfits, "snapshots_left": left,
        "resumed_sweeps": ran[2], "snapshot_loads": loads,
        "child_cp_als_s": child_s, "seconds": secs}


def snapshot_ms(factors, lam, fits):
    """Milliseconds of one ``SnapshotStore.save`` (the copy off the card
    and the npz write) and one ``latest`` (read and digest check) of
    ``factors``, in a temporary directory."""
    import tempfile

    import torch
    from repro_torch.resilience import SnapshotStore

    with tempfile.TemporaryDirectory() as tmp:
        store = SnapshotStore(tmp)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        store.save("ab" * 32, 1, factors, lam, fits)
        t1 = time.perf_counter()
        snap = store.latest("ab" * 32)
        t2 = time.perf_counter()
    if snap is None or snap.sweep != 1:
        raise AssertionError("snapshot did not load back")
    mb = sum(f.numel() * f.element_size() for f in factors) / 2**20
    return {"save_ms": 1e3 * (t1 - t0), "load_ms": 1e3 * (t2 - t1),
            "mib": mb}


def span_ms(tracer, name, since=0):
    """Milliseconds of the spans ``name`` that started after ``since``
    (perf_counter_ns)."""
    return [s.duration_ns / 1e6 for s in tracer.spans()
            if s.name == name and s.start_ns >= since]


def phase_backend_rung(kmt, t, factors, cuda_fits, tracer, report):
    """[13b] ``cp_als(ladder=True)`` on [3]'s nell1 0.1 tensor and
    factors with ``compile_fail=("cuda_fused",)``: one ``compile``
    degradation to ``cuda``, the pre-gathered kernel launching instead
    of the balanced pair, fits within ``FIT_ATOL`` of [7]'s ``cuda``
    fits from the same factors; with both kernel backends failing, one
    rung and then the error (the card's ladder ends at ``cuda``); and a
    snapshot's save and load at this size."""
    import torch
    from repro_torch import obs
    from repro_torch.core import cp_als
    from repro_torch.engine import ExecutionConfig
    from repro_torch.resilience import (ChaosCompileError, ChaosSpec,
                                        install, uninstall)

    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK)
    degr = obs.REGISTRY.counter("resilience_degradations")
    before = degr.as_dict()
    kmt.reset_launch_counts()
    install(ChaosSpec(compile_fail=("cuda_fused",)))
    t0 = time.perf_counter_ns()
    try:
        res = cp_als(t, RANK, iters=3, config=cfg, factors=factors,
                     ladder=True)
        torch.cuda.synchronize()
    finally:
        uninstall()
    secs = (time.perf_counter_ns() - t0) / 1e9
    steps = {k: v - before.get(k, 0) for k, v in degr.as_dict().items()
             if v != before.get(k, 0)}
    if steps != {"compile:cuda_fused->cuda": 1}:
        raise AssertionError(f"[13b] degradations taken: {steps}")
    pre = kmt.LAUNCHES["mttkrp_fused_compact"]
    fused = (kmt.LAUNCHES["mttkrp_fused_remap_compact"]
             + kmt.LAUNCHES["mttkrp_fused_gather_compact"])
    if pre != 3 * t.nmodes or fused != 0:
        raise AssertionError(f"[13b] launches: pre-gathered {pre}, "
                             f"balanced {fused}")
    gap = max(abs(a - b) for a, b in zip(res.fits, cuda_fits))
    if not all(f == f for f in res.fits) or gap > FIT_ATOL:
        raise AssertionError(f"[13b] fits {res.fits} vs [7] {cuda_fits}")
    rebuild = span_ms(tracer, "engine.init", t0)
    # the card's ladder ends at cuda: when both kernel backends fail to
    # build, cp_als raises and no rung hands the tensors to plain PyTorch
    before = degr.as_dict()
    install(ChaosSpec(compile_fail=("cuda_fused", "cuda")))
    try:
        cp_als(t, RANK, iters=1, config=cfg, factors=factors, ladder=True)
    except ChaosCompileError:
        pass
    else:
        raise AssertionError("[13b] cp_als ran on after both kernel "
                             "backends failed to build")
    finally:
        uninstall()
    steps = {k: v - before.get(k, 0) for k, v in degr.as_dict().items()
             if v != before.get(k, 0)}
    if steps != {"compile:cuda_fused->cuda": 1}:
        raise AssertionError(f"[13b] degradations taken when both kernel "
                             f"backends fail: {steps}")
    snap = snapshot_ms(res.factors, res.lam, res.fits)
    log(f"[13b] compile_fail cuda_fused -> cuda: 1 degradation, "
        f"mttkrp_fused_compact launches {pre}, balanced 0; fits {res.fits} "
        f"([7] cuda {cuda_fits}, max diff {gap:.2e}); cp_als with the rung "
        f"{secs:.2f} s, the rebuild (engine.init under cuda) "
        f"{rebuild[-1]:.1f} ms; both kernel backends failing raised "
        f"after the one rung; snapshot of {snap['mib']:.1f} MiB: save "
        f"{snap['save_ms']:.1f} ms, load {snap['load_ms']:.1f} ms")
    report["backend_rung"] = {"fits": res.fits, "cuda_fits": cuda_fits,
                              "fit_gap": gap, "launches": pre,
                              "seconds": secs, "rebuild_ms": rebuild,
                              "snapshot": snap}


def phase_residency_rung(ctx, tracer, report):
    """[13c] A real ``torch.cuda.OutOfMemoryError`` in ``engine.init``:
    [12d]'s vast tensor with the allocator capped between the streamed
    and the resident ``init`` peak. ``make_engine(PlanSpec(residency=
    "full"))`` without a ladder must raise it; with ``ladder=True`` it
    must record ``oom: full -> stream`` and return the stream, whose
    rotation holds [12d]'s oracle limit under the cap. The cap is lifted
    after."""
    import torch
    from repro_torch import obs
    from repro_torch.engine import PlanSpec, StreamState, make_engine
    from repro_torch.engine.stream import stream_all_modes

    # [12d]'s planned tensor, its dedup tables already built: through
    # the cache a COO triple would come back as a new tensor without them
    t, cache, factors = (ctx[k] for k in ("t", "cache", "factors"))
    spec = PlanSpec(backend="cuda_fused", rank_hint=RANK, residency="full",
                    device_budget_bytes=ctx["budget"])
    free_device_memory()
    held = torch.cuda.memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    lo, hi = ctx["peak_stream"], ctx["peak_init"]
    if not hi > 1.5 * lo:
        raise AssertionError(f"[13c] resident init peak {hi} too close to "
                             f"the streamed peak {lo} for a cap between")
    cap = held + (lo + hi) // 2
    degr = obs.REGISTRY.counter("resilience_degradations")
    before = degr.get("oom:full->stream", 0)
    torch.cuda.set_per_process_memory_fraction(cap / total)
    try:
        t0 = time.perf_counter()
        try:
            make_engine(t, spec, cache=cache)
        except torch.cuda.OutOfMemoryError as exc:
            refused = str(exc).splitlines()[0][:120]
        else:
            raise AssertionError("[13c] the resident init fit under the "
                                 "cap without a ladder")
        no_ladder_s = time.perf_counter() - t0
        free_device_memory()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter_ns()
        ss = make_engine(t, spec, cache=cache, ladder=True)
        rung_s = (time.perf_counter_ns() - t1) / 1e9
        if not isinstance(ss, StreamState):
            raise AssertionError(f"[13c] the rung returned "
                                 f"{type(ss).__name__}")
        peak_rung = torch.cuda.max_memory_allocated()
        after_rung = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t2 = time.perf_counter()
        outs, ss = stream_all_modes(ss, factors)
        torch.cuda.synchronize()
        rot_s = time.perf_counter() - t2
        peak = torch.cuda.max_memory_allocated()
        outs = [o.cpu() for o in outs]
    finally:
        torch.cuda.set_per_process_memory_fraction(1.0)
    if degr.get("oom:full->stream", 0) != before + 1:
        raise AssertionError(f"[13c] degradations {degr.as_dict()}")
    shares = [close_to(f"[13c] vast mode {d} after the rung", outs[d],
                       *ctx["oracle"][d])[1] for d in range(t.nmodes)]
    del ss, outs
    free_device_memory()
    init_ms = span_ms(tracer, "stream.init", t1)
    snap = snapshot_ms(factors, torch.ones(RANK, device="cuda"), [0.5])
    log(f"[13c] vast under a cap of {cap / 2**30:.3f} GiB ({held / 2**30:.3f}"
        f" held; streamed peak {lo / 2**30:.3f}, resident init peak "
        f"{hi / 2**30:.3f} GiB): without a ladder make_engine raised "
        f"({refused!r}) after {no_ladder_s:.1f} s; with ladder=True "
        f"oom: full -> stream in {rung_s:.1f} s (stream.init "
        f"{init_ms[-1] / 1e3:.1f} s); rotation {rot_s:.1f} s, each mode == "
        f"mttkrp_ref ({max(shares):.2e} of the limit); peak under the cap "
        f"{peak_rung / 2**30:.3f} GiB in the rung (the failed init's "
        f"partial state included), {after_rung / 2**30:.3f} held after "
        f"it, {peak / 2**30:.3f} in the rotation; snapshot of {snap['mib']:.1f} MiB: save "
        f"{snap['save_ms']:.1f} ms, load {snap['load_ms']:.1f} ms")
    report["residency_rung"] = {
        "cap_bytes": cap, "held_bytes": held, "peak_stream": lo,
        "peak_init": hi, "refused": refused, "no_ladder_s": no_ladder_s,
        "rung_s": rung_s, "stream_init_ms": init_ms[-1],
        "rotation_s": rot_s, "peak_rung": peak_rung,
        "held_after_rung": after_rung, "peak_rotation": peak,
        "max_share": max(shares), "snapshot": snap}


def phase_stream_rungs(kmt, t, factors, report):
    """[13d] nell1 0.1 streamed on ``cuda_fused`` ([12a]'s chunking):
    ``oom_chunk`` halves the chunk budget once and replans, the
    ``upload_fail`` fault is retried twice; every mode of both within the
    oracle limit."""
    import torch
    from repro_torch.engine import ExecutionConfig
    from repro_torch.engine.stream import stream_all_modes, stream_init
    from repro_torch.resilience import (DEFAULT_POLICY, ChaosSpec, install,
                                        uninstall)

    oracle = mttkrp_oracle(torch.from_numpy(t.indices).cuda(),
                           torch.from_numpy(t.values).cuda(), factors,
                           t.dims)
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK,
                          residency="stream", chunk_nnz=STREAM_CHUNK)
    rows = {}
    for tag, spec, field, want in (
            ("oom_chunk", ChaosSpec(oom_chunk=OOM_CHUNK), "budget_halvings",
             1),
            ("upload_fail", ChaosSpec(upload_fail=0, upload_fail_times=2),
             "upload_retries", 2)):
        ss = stream_init(t, cfg)
        install(spec)
        t0 = time.perf_counter_ns()
        try:
            outs, ss = stream_all_modes(ss, factors, policy=DEFAULT_POLICY)
            torch.cuda.synchronize()
        finally:
            uninstall()
        secs = (time.perf_counter_ns() - t0) / 1e9
        got = getattr(ss.stats, field)
        if got != want:
            raise AssertionError(f"[13d] {tag}: {field} {got}, not {want}")
        shares = [close_to(f"[13d] {tag} mode {d}", outs[d], *oracle[d])[1]
                  for d in range(t.nmodes)]
        rows[tag] = {field: got, "max_share": max(shares), "seconds": secs,
                     "target_slots": ss.plan.target_slots,
                     "chunks": [cs.nchunks for cs in ss.plan.chunks]}
        del outs, ss
    del oracle
    free_device_memory()
    report["stream_rungs"] = rows
    return rows


def phase_nan_guard(t, factors, clean_fits, report):
    """[13e] ``nan_sweep=1`` with ``ladder=True``: a ``nan_rollback``
    recovery, finite fits within ``FIT_ATOL`` of [3]'s clean run from the
    same factors."""
    from repro_torch import obs
    from repro_torch.core import cp_als
    from repro_torch.engine import ExecutionConfig
    from repro_torch.resilience import ChaosSpec, install, uninstall

    rec = obs.REGISTRY.counter("resilience_recoveries")
    before = rec.get("nan_rollback", 0)
    install(ChaosSpec(nan_sweep=1))
    t0 = time.perf_counter()
    try:
        res = cp_als(t, RANK, iters=3, factors=factors, ladder=True,
                     config=ExecutionConfig(backend="cuda_fused",
                                            rank_hint=RANK))
    finally:
        uninstall()
    secs = time.perf_counter() - t0
    gap = max(abs(a - b) for a, b in zip(res.fits, clean_fits))
    if rec.get("nan_rollback", 0) != before + 1 or gap > FIT_ATOL \
            or not all(f == f for f in res.fits):
        raise AssertionError(f"[13e] fits {res.fits} vs clean {clean_fits}, "
                             f"recoveries {rec.as_dict()}")
    log(f"[13e] nan_sweep=1: 1 nan_rollback; fits {res.fits} (clean "
        f"{clean_fits}, max diff {gap:.2e}); {secs:.2f} s")
    report["nan_guard"] = {"fits": res.fits, "fit_gap": gap,
                           "seconds": secs}


def phase_resilience(kmt, t, factors, vast, report):
    """[13] Resilience on the card: [13a] kill and resume, [13b] the
    backend rung, [13c] the residency rung on a real OOM, [13d] the
    stream's rungs, [13e] the NaN guard, [13f] the report pairing every
    injected fault with its answer and the phase's Chrome trace."""
    from repro_torch import obs

    tracer = obs.enable(obs.Tracer(profiler_annotations=False))
    t0 = time.perf_counter()
    try:
        phase_kill_resume(report)
        phase_backend_rung(kmt, t, factors,
                           report["cuda_compact"]["fits"], tracer, report)
        phase_residency_rung(vast, tracer, report)
        rows = phase_stream_rungs(kmt, t, factors, report)
        phase_nan_guard(t, factors, report["nell1"]["fits"], report)
    finally:
        obs.disable()
    replan = span_ms(tracer, "stream.replan")
    o, u = rows["oom_chunk"], rows["upload_fail"]
    log(f"[13d] oom_chunk={OOM_CHUNK}: 1 budget halving (target "
        f"{o['target_slots']} slots after, chunks a mode {o['chunks']}), "
        f"the replan {replan[0]:.1f} ms, rotation {o['seconds']:.2f} s, "
        f"{o['max_share']:.2e} of the limit; upload_fail=0 x2: 2 retries, "
        f"rotation {u['seconds']:.2f} s, {u['max_share']:.2e} of the limit")
    rep = obs.resilience_report()
    want = {"compile_fail", "oom_chunk", "upload_fail", "nan_burst"}
    if rep["unanswered"] or set(rep["injections"]) != want \
            or set(rep["answered"]) != want:
        raise AssertionError(f"[13f] resilience report {rep}")
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    path = out_dir / "chip_smoke_trace13.json"
    trace = obs.write_chrome_trace(
        str(path), tracer, manifest=obs.run_manifest(extra={"phase": 13}))
    problems = obs.validate_chrome_trace(trace)
    if problems:
        raise AssertionError(f"[13f] trace: {problems[:5]}")
    secs = time.perf_counter() - t0
    log(f"[13f] every injection answered ({rep['answered']}), none silent; "
        f"degradations {rep['degradations']}, retries {rep['retries']}, "
        f"recoveries {rep['recoveries']}; Chrome trace of [13] "
        f"({trace['metadata']['span_count']} spans) valid, in {path.name}; "
        f"[13] took {secs:.1f} s")
    report["resilience"] = {"report": rep, "replan_ms": replan,
                            "trace_spans": trace["metadata"]["span_count"],
                            "seconds": secs}


# --------------------------------------------------------------------------
# [14] The distributed tier.
# --------------------------------------------------------------------------
DIST_SHARDS = 4                # [14a]: nell1 0.1's shards, all on cuda:0
DIST_SCALE = 0.01              # [14e]: the children's nell1, [8]'s scale
DIST_KILL_SWEEP = 3


def dist_mesh(n, shape=None, axes=("data",)):
    """``n`` shards on ``cuda:0`` (the shape defaults to ``(n,)``)."""
    from repro_torch.launch.mesh import make_mesh

    return make_mesh(shape or (n,), axes, devices=["cuda:0"] * n)


def dist_expected(state, ds, factors):
    """The layouts a distributed rotation must leave after each
    transition: ``shard_state`` of the single-device engine's layout
    after the same transitions (host arrays); the last, back at the start
    mode, is ``ds``'s own (``shard_state`` of ``state``)."""
    from repro_torch import engine
    from repro_torch.engine import dist

    out = []
    for _ in range(state.nmodes - 1):
        _, state = engine.mttkrp(state, factors)
        out.append(dist.shard_state(state, ds.mesh).host_layout())
    return out + [ds.host_layout()]


def dist_check(kmt, tag, ds0, factors, oracle, names, single=None,
               expected=None):
    """One ``dist_all_modes`` rotation of ``ds0`` (the launch counts and
    the copied bytes read around it): each mode against the oracle and,
    with ``single`` (a single-device rotation's outputs), within the same
    limit of it; the layout back at its start; each of ``names``
    launched once a shard a mode; the bytes copied between shards
    ``n_dev`` times ``exchange_bytes``. With ``expected``
    (:func:`dist_expected`) the rotation is stepped again with
    ``dist_mttkrp``, each layout after a transition held bitwise to it.
    Returns a row of numbers and the stepped layouts."""
    import numpy as np
    import torch
    from repro_torch import obs
    from repro_torch.engine import dist

    n, n_dev = ds0.nmodes, ds0.n_dev
    exchange = ds0.dist.exchange
    counter = obs.REGISTRY.counter("dist_copied_bytes")
    before = counter.as_dict()
    kmt.reset_launch_counts()
    outs, ds1 = dist.dist_all_modes(ds0, factors)
    torch.cuda.synchronize()
    launches = dict(kmt.LAUNCHES)
    after = counter.as_dict()
    for name in names:
        if launches[name] != n * n_dev * ds0.grid.shape[1]:
            raise AssertionError(f"{tag}: {name} launched {launches[name]} "
                                 f"times in a rotation of {n} modes over "
                                 f"{n_dev} shards")
    xb = dist.exchange_bytes(ds0.schedule, n, ds0.slocs)
    copied = [after.get(f"{exchange}:mode{d}", 0)
              - before.get(f"{exchange}:mode{d}", 0) for d in range(n)]
    want = [n_dev * e[f"{exchange}_bytes"] for e in xb]
    if copied != want:
        raise AssertionError(f"{tag}: copied {copied} bytes a transition, "
                             f"the schedule says {want}")
    shares, sshares = [], []
    for d in range(n):
        shares.append(close_to(f"{tag} mode {d} vs mttkrp_ref", outs[d],
                               *oracle[d])[1])
        if single is not None:
            sshares.append(close_to(f"{tag} mode {d} vs single device",
                                    outs[d], single[d], oracle[d][1])[1])
    for name, a, b in zip(("val", "idx", "alpha"), ds1.host_layout(),
                          ds0.host_layout()):
        if not np.array_equal(a, b):
            raise AssertionError(f"{tag}: layout {name} not back after the "
                                 "rotation")
    lays = []
    if expected is not None:
        ds = ds0
        for i in range(n):
            _, ds = dist.dist_mttkrp(ds, factors)
            lays.append(ds.host_layout())
            for name, a, b in zip(("val", "idx", "alpha"), lays[-1],
                                  expected[i]):
                if not np.array_equal(a, b):
                    raise AssertionError(f"{tag}: layout {name} after "
                                         f"transition {i} differs from "
                                         "shard_state of the single-device "
                                         "layout")
    row = {"launches": {k: launches[k] for k in names},
           "copied_bytes": copied, "max_share": max(shares),
           "single_share": max(sshares) if sshares else None,
           "hops": [list(h) for h in ds0.schedule.hops],
           "exchange_bytes": xb}
    log(f"{tag}: {n} modes over {n_dev} shards == mttkrp_ref "
        f"({max(shares):.2e} of the limit"
        + (f"; the single-device rotation {max(sshares):.2e}"
           if sshares else "")
        + f"); launches {row['launches']}; copied {copied} B a transition "
        f"(= {n_dev} x exchange_bytes); layout back at its start"
        + ("; layouts after each transition bitwise shard_state of the "
           "single-device engine's" if expected is not None else ""))
    return row, lays


def dist_times(kmt, ds, factors, reps):
    """[14a]'s timings on the card (CUDA events, median of ``reps``): per
    mode the exchange of each kind, and per shard the gather kernel (on
    its work table), its plain version, the torch backend and the byte
    bound of the shard's real blocks."""
    import torch
    from repro_torch.engine import dist
    from repro_torch.engine.backends import ec_torch

    n, n_dev = ds.nmodes, ds.n_dev
    modes = []
    errs = 0.0
    for _ in range(n):
        d = ds.mode
        ls = ds.lstatics[d]
        parts = [dist.shard_layout(ds, k, d) for k in range(n_dev)]
        local = [(L["val"], L["idx"], L["alpha"]) for L, _ in parts]
        alive = [a for _, a in parts]
        kw = dict(d=d, nxt=(d + 1) % n, smax_loc=ds.smax_loc, n_dev=n_dev,
                  nmodes=n, devices=ds.devices)
        row = {"mode": d, "exchange_ms": {
            "permute": cuda_median_ms(lambda: dist._exchange_permute(
                local, alive, hops=ds.schedule.hops[d], **kw), reps),
            "all_gather": cuda_median_ms(lambda: dist._exchange_all_gather(
                local, alive, **kw), reps)}, "shards": []}
        inputs = tuple(f for w, f in enumerate(factors) if w != d)
        kk = dict(kappa=ls.kappa, rows_pp=ls.rows_pp, nblocks=ls.nblocks,
                  block_p=ls.block_p)
        for k, (L, live) in enumerate(parts):
            got = run_gather(kmt, L, inputs, kk)
            want = run_gather(kmt, L, inputs, kk, plain=True)
            lim = limit(*row_stats(kmt, L, inputs, kk), n, sides=2)
            errs = max(errs, close_to(f"[14a] mode {d} shard {k} gather "
                                      "out_rel", got, want, lim)[0])
            nreal = int(L["work"][:, 2].max())
            nbytes, _ = byte_bound(L, ls._replace(nblocks=nreal), d,
                                   ds.smax_loc, n, RANK, False)
            flops = int(live.sum()) * RANK * n
            row["shards"].append({
                "ms": cuda_median_ms(lambda: run_gather(kmt, L, inputs, kk),
                                     reps),
                "plain_ms": cuda_median_ms(
                    lambda: run_gather(kmt, L, inputs, kk, plain=True),
                    reps),
                "torch_backend_ms": cuda_median_ms(
                    lambda: ec_torch(L, factors, d, plan=ls,
                                     config=ds.config), reps),
                "bytes": nbytes, "flops": flops, "real_blocks": nreal,
                "bound_ms": 1e3 * max(nbytes / HBM_BYTES_PER_S,
                                      flops / F32_FLOP_PER_S)})
        modes.append(row)
        _, ds = dist.dist_mttkrp(ds, factors)
    torch.cuda.synchronize()
    return modes, errs


def phase_dist_nell1(kmt, t, factors, nell1, report, reps):
    """[14a] nell1 scale 0.1 ([3]'s nonzeros and factors) planned by
    ``build_sharded_flycoo(n_dev=4)`` and sharded 4 ways on ``cuda:0``:
    one ``dist_all_modes`` rotation under each exchange (the main
    distributed path), checked by :func:`dist_check` against the oracle,
    the single-device ``cuda_fused`` rotation and ``shard_state`` of its
    layouts, the two exchanges' layouts against each other, then timed;
    where torch sees 2 or more cards, again with a shard a card (2 or
    4).
    [14b] ``cp_als(mesh=)``, 3 sweeps, against [3]'s single-device run
    (``nell1``: the same nonzeros and factors) and its float64 ALS
    witness from these factors (seed 0). [14d] the gate: with one hop
    of the first transition dropped (its cap set to 0, so nothing of it
    is copied) the layout check and the next mode's oracle check must
    fail. Returns the [14a] rows and launch counts."""
    import numpy as np
    import torch
    from repro_torch import engine
    from repro_torch.core import build_sharded_flycoo, cp_als
    from repro_torch.engine import DistConfig, ExecutionConfig, dist

    t0 = time.perf_counter()
    ts = build_sharded_flycoo(t.indices, t.values, t.dims, n_dev=DIST_SHARDS)
    n = ts.nmodes
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK)
    state = engine.init(ts, cfg)
    mesh = dist_mesh(DIST_SHARDS)
    oracle = mttkrp_oracle(torch.from_numpy(t.indices).cuda(),
                           torch.from_numpy(t.values).cuda(), factors,
                           t.dims)
    single, _ = engine.all_modes(state, factors)
    for d in range(n):
        close_to(f"[14a] single-device mode {d}", single[d], *oracle[d])
    ds = dist.shard_state(state, mesh)
    # the exchange rung's own switch: the same shards, the other exchange
    states = {ex: ds.replace(dist=DistConfig(exchange=ex))
              for ex in dist.EXCHANGES}
    expected = dist_expected(state, ds, factors)
    setup_s = time.perf_counter() - t0
    log(f"[14a] nell1 0.1 sharded {DIST_SHARDS} ways on cuda:0 (4 shards "
        f"on one card): kappa {[s.kappa for s in ts.plans]} (rows_pp "
        f"{[s.rows_pp for s in ts.plans]}), slots a shard {list(ds.slocs)}, "
        f"hop caps {[list(h) for h in ds.schedule.hops]}; set-up "
        f"{setup_s:.1f} s")
    rows, lays = {}, {}
    for ex in dist.EXCHANGES:
        rows[ex], lays[ex] = dist_check(
            kmt, f"[14a] nell1 0.1 {ex}", states[ex], factors, oracle,
            ("mttkrp_fused_gather_compact",), single=single,
            expected=expected)
    for i, (a, b) in enumerate(zip(lays["permute"], lays["all_gather"])):
        if not all(np.array_equal(x, y) for x, y in zip(a, b)):
            raise AssertionError(f"[14a] permute and all_gather layouts "
                                 f"differ after transition {i}")
    launches = rows["permute"]["launches"]
    rot = {ex: cuda_median_ms(lambda: dist.dist_all_modes(states[ex],
                                                          factors), reps)
           for ex in dist.EXCHANGES}
    single_ms = cuda_median_ms(lambda: engine.all_modes(state, factors),
                               reps)
    times, kerr = dist_times(kmt, ds, factors, reps)
    for m in times:
        sh = m["shards"]
        log(f"[14a] mode {m['mode']} (4 shards on one card): exchange "
            f"permute {m['exchange_ms']['permute']:.3f} ms, all_gather "
            f"{m['exchange_ms']['all_gather']:.3f} ms; per shard gather "
            f"kernel " + ", ".join(f"{x['ms']:.3f}" for x in sh)
            + " ms (bound " + ", ".join(f"{x['bound_ms']:.4f}" for x in sh)
            + "; plain " + ", ".join(f"{x['plain_ms']:.3f}" for x in sh)
            + "; torch backend "
            + ", ".join(f"{x['torch_backend_ms']:.3f}" for x in sh) + ")")
    log(f"[14a] rotation (4 shards on one card, not a multi-GPU speed): "
        f"permute {rot['permute']:.3f} ms, all_gather "
        f"{rot['all_gather']:.3f} ms; the single-device cuda_fused "
        f"rotation {single_ms:.3f} ms; kernel vs plain max err {kerr:.3e}")
    cards = torch.cuda.device_count()
    multi = None
    if cards >= 2:
        # a shard a card: the same checks, then the rotation timed
        from repro_torch.launch.mesh import make_mesh

        nc = 4 if cards >= 4 else 2
        dsc = dist.shard_state(state, make_mesh((nc,), ("data",)))
        multi, _ = dist_check(kmt, f"[14a] nell1 0.1 over {nc} cards", dsc,
                              factors, oracle,
                              ("mttkrp_fused_gather_compact",),
                              single=single)
        multi["rotation_ms"] = cuda_median_ms(
            lambda: dist.dist_all_modes(dsc, factors), reps)
        log(f"[14a] rotation over {nc} cards, a shard a card: "
            f"{multi['rotation_ms']:.3f} ms")
        del dsc

    # ---- [14b] cp_als over the shards ------------------------------------
    fits1 = nell1["fits"]
    f64 = nell1["fit_witness"][0]["f64_fits"]
    fits = cp_als(ts, RANK, iters=3, config=cfg, factors=factors,
                  mesh=mesh).fits
    gaps = (max(abs(a - b) for a, b in zip(fits, fits1)),
            max(abs(a - b) for a, b in zip(fits, f64)))
    if not all(f == f and abs(f) < 1e30 for f in fits) \
            or max(gaps) > FIT_ATOL:
        raise AssertionError(f"[14b] cp_als(mesh=) fits {fits} vs single "
                             f"device {fits1}, float64 {f64}")
    log(f"[14b] cp_als over 4 shards: fits {fits} ([3]'s single-device "
        f"run {fits1}, max diff {gaps[0]:.2e}; its float64 witness "
        f"{gaps[1]:.2e})")

    # ---- [14d] a dropped hop must fail the checks ------------------------
    hops = [list(h) for h in ds.schedule.hops]
    h = next(i for i, c in enumerate(hops[0]) if c)
    hops[0][h] = 0
    mutant = ds.replace(schedule=dist.ExchangeSchedule(
        ds.n_dev, tuple(tuple(x) for x in hops)))
    _, m1 = dist.dist_mttkrp(mutant, factors)
    caught = []
    if not all(np.array_equal(a, b) for a, b in zip(m1.host_layout(),
                                                    expected[0])):
        caught.append("layout")
    out1, _ = dist.dist_mttkrp(m1, factors)
    try:
        close_to("[14d] dropped-hop mutant mode 1", out1, *oracle[1])
    except AssertionError as exc:
        caught.append(str(exc))
    if len(caught) != 2:
        raise AssertionError(f"[14d] a rotation with hop {h + 1} of "
                             f"transition 0 dropped passed: {caught}")
    log(f"[14d] hop {h + 1} of transition 0 dropped: the layout check and "
        f"the next mode's limit both fail ({caught[1]})")
    report["dist_nell1"] = {
        "kappa": [p.kappa for p in ts.plans], "slocs": list(ds.slocs),
        "rows": rows, "rotation_ms": rot, "single_rotation_ms": single_ms,
        "times": times, "kernel_err": kerr, "fits": fits,
        "single_fits": fits1, "f64_fits": f64, "fit_gaps": gaps,
        "mutant": caught, "setup_s": setup_s, "cards": multi}
    del states, ds, mutant, m1, state, oracle, single, expected
    free_device_memory()
    return times, launches, kerr


def phase_dist_more(kmt, small, twitch, report):
    """[14c] the other kernels of the distributed path, each rotation
    against the oracle: twitch (``twitch``, [5]'s COO, 5 modes) on 4
    shards, the ``cuda`` backend (pre-gathered, compact) on nell1 0.01
    (``small``, [8]'s COO) over 4 shards, rect ``cuda_fused`` on it over 2
    shards, and a (2, 2) data x model mesh on it (the rank split over the
    model axis)."""
    import torch
    from repro_torch import engine
    from repro_torch.core import build_sharded_flycoo, init_factors
    from repro_torch.engine import DistConfig, ExecutionConfig, dist

    rows = {}
    cases = (
        ("twitch 0.01 cuda_fused", twitch, 4, None, "cuda_fused",
         "mttkrp_fused_gather_compact", {}),
        ("nell1 0.01 cuda", small, 4, None, "cuda",
         "mttkrp_fused_compact", {}),
        ("nell1 0.01 rect cuda_fused", small, 2, "rect", "cuda_fused",
         "mttkrp_fused_gather", {}),
        ("nell1 0.01 data x model (2, 2) cuda_fused", small, 4, None,
         "cuda_fused", "mttkrp_fused_gather_compact",
         {"model_axis": "model"}))
    for tag, coo, n_dev, schedule, backend, kname, dkw in cases:
        t0 = time.perf_counter()
        t = build_sharded_flycoo(*coo, n_dev=2 if schedule else n_dev,
                                 schedule=schedule)
        factors = init_factors(torch.Generator(device="cuda").manual_seed(2),
                               t.dims, RANK)
        oracle = mttkrp_oracle(torch.from_numpy(t.indices).cuda(),
                               torch.from_numpy(t.values).cuda(), factors,
                               t.dims)
        state = engine.init(t, ExecutionConfig(backend=backend,
                                               rank_hint=RANK))
        if dkw:
            mesh = dist_mesh(4, (2, 2), ("data", "model"))
        else:
            mesh = dist_mesh(n_dev)
        ds = dist.shard_state(state, mesh, DistConfig(**dkw))
        if schedule == "rect":
            log(f"[14c] {tag}: {list(ds.slocs)} slots a shard")
        rows[tag], _ = dist_check(kmt, f"[14c] {tag}", ds, factors, oracle,
                                  (kname,))
        rows[tag]["seconds"] = time.perf_counter() - t0
        del state, ds, oracle
    report["dist_more"] = rows
    free_device_memory()
    return rows


def dist_child(ckpt, out, mode, n):
    """``--dist-child``: ``cp_als`` on ``cuda_fused`` at nell1 scale
    ``DIST_SCALE`` planned for 4 shards, over ``n`` shards on ``cuda:0``,
    ``ALS_SWEEPS`` sweeps, a snapshot every sweep into ``ckpt``; ``mode``
    "resume" resumes from it. Writes the factors, lam and fits to
    ``out``, with the sweeps this process ran and the snapshots it
    loaded."""
    import numpy as np
    import torch
    from repro_torch.core import (build_sharded_flycoo, cp_als,
                                  init_factors, spec, synthesize)
    from repro_torch.engine import ExecutionConfig
    from repro_torch.obs import trace
    from repro_torch.resilience import SnapshotStore

    torch.backends.cuda.matmul.allow_tf32 = False
    ts = spec("nell1", scale=DIST_SCALE)
    indices, values = synthesize(ts, seed=0)
    t = build_sharded_flycoo(indices, values, ts.dims, n_dev=4)
    factors = init_factors(torch.Generator(device="cuda").manual_seed(0),
                           t.dims, RANK)
    store = SnapshotStore(ckpt) if ckpt else None
    tracer = trace.enable()
    t0 = time.perf_counter()
    res = cp_als(t, RANK, iters=ALS_SWEEPS,
                 config=ExecutionConfig(backend="cuda_fused",
                                        rank_hint=RANK),
                 factors=factors, mesh=dist_mesh(int(n)), checkpoint=store,
                 resume=mode == "resume")
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    sweeps = [r.attrs["sweep"] for r in tracer.spans()
              if r.name == "cpd.sweep"]
    np.savez(out, *[f.cpu().numpy() for f in res.factors],
             lam=res.lam.cpu().numpy(), fits=np.asarray(res.fits),
             seconds=secs, sweeps=np.asarray(sweeps, np.int64),
             loads=store.loads if store is not None else 0)
    return 0


def run_dist_children(jobs):
    """Run ``--dist-child`` processes at once; ``jobs`` is a list of
    ``(ckpt, out, mode, n, chaos)``. Returns their return codes and
    standard errors, in order."""
    import os

    procs = []
    for ckpt, out, mode, n, chaos in jobs:
        env = {k: v for k, v in os.environ.items()
               if k not in RESILIENCE_ENV}
        if chaos:
            env["REPRO_CHAOS"] = chaos
        procs.append(subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--dist-child",
             ckpt, out, mode, str(n)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    out = []
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            out.append((p.returncode, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def phase_dist_resilience(small, report):
    """[14e] at nell1 scale 0.01 (``small``, [8]'s COO; the children
    synthesize it again) over 4 shards on ``cuda:0``: the exchange
    rung (``exchange_fail=1``: ``permute -> all_gather``) and the
    device-loss rung (``device_lost=1``, 2 lost: re-shard on 2) against a
    clean 4-shard ``cp_als``, fits within ``FIT_ATOL``; then
    ``--dist-child`` processes: a clean run on 4 shards beside one killed
    at sweep ``DIST_KILL_SWEEP`` (SIGKILL), whose snapshots resume on 2
    and on 1 shard, each within ``FIT_ATOL`` of the clean run and keeping
    the snapshot's fits bitwise."""
    import os
    import shutil
    import signal
    import tempfile

    import numpy as np
    from repro_torch import obs
    from repro_torch.core import build_sharded_flycoo, cp_als, init_factors
    from repro_torch.engine import ExecutionConfig
    import torch
    from repro_torch.resilience import (ChaosSpec, LadderPolicy,
                                        SnapshotStore, install, uninstall)

    t0 = time.perf_counter()
    t = build_sharded_flycoo(*small, n_dev=4)
    factors = init_factors(torch.Generator(device="cuda").manual_seed(0),
                           t.dims, RANK)
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK)
    mesh = dist_mesh(4)
    clean = cp_als(t, RANK, iters=4, config=cfg, factors=factors,
                   mesh=mesh).fits
    policy = LadderPolicy(backoff_base_s=1e-4, backoff_cap_s=1e-3)
    degr = obs.REGISTRY.counter("resilience_degradations")
    rungs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for tag, spec_, label in (
                ("exchange_fail", ChaosSpec(exchange_fail=1),
                 "exchange:permute->all_gather"),
                ("device_lost", ChaosSpec(device_lost=1, device_lost_n=2),
                 "device_lost:4->2")):
            before = degr.as_dict().get(label, 0)
            install(spec_)
            try:
                got = cp_als(t, RANK, iters=4, config=cfg, factors=factors,
                             mesh=mesh, ladder=policy,
                             checkpoint=os.path.join(tmp, tag)).fits
            finally:
                uninstall()
            gap = max(abs(a - b) for a, b in zip(got, clean))
            if degr.as_dict().get(label, 0) != before + 1 or gap > FIT_ATOL:
                raise AssertionError(f"[14e] {tag}: fits {got} vs clean "
                                     f"{clean}, degradations "
                                     f"{degr.as_dict()}")
            rungs[tag] = {"fits": got, "gap": gap}
            log(f"[14e] {tag}: the rung {label} once, fits within {gap:.2e} "
                f"of the clean 4-shard run")
        ck = os.path.join(tmp, "ckpt")
        out = {k: os.path.join(tmp, f"{k}.npz")
               for k in ("clean", "resumed2", "resumed1")}
        (rc_a, err_a), (rc_k, err_k) = run_dist_children([
            ("", out["clean"], "fresh", 4, None),
            (ck, os.devnull, "fresh", 4, f"kill_sweep={DIST_KILL_SWEEP}")])
        if rc_a != 0:
            raise AssertionError(f"[14e] clean child exited {rc_a}: "
                                 f"{err_a[-2000:]}")
        if rc_k != -signal.SIGKILL:
            raise AssertionError(f"[14e] killed child exited {rc_k}: "
                                 f"{err_k[-2000:]}")
        left = sorted(os.listdir(ck)) if os.path.isdir(ck) else []
        if not left:
            raise AssertionError("[14e] no snapshot survived the kill")
        store = SnapshotStore(ck)
        snap = max((store.load(os.path.join(ck, f)) for f in left),
                   key=lambda x: x.sweep)
        if snap.sweep != DIST_KILL_SWEEP or snap.mesh["n_dev"] != 4:
            raise AssertionError(f"[14e] the killed child's newest snapshot "
                                 f"is at sweep {snap.sweep}, mesh "
                                 f"{snap.mesh}")
        for n in (2, 1):
            shutil.copytree(ck, ck + str(n))
        res = run_dist_children([
            (ck + "2", out["resumed2"], "resume", 2, None),
            (ck + "1", out["resumed1"], "resume", 1, None)])
        for (rc, err), n in zip(res, (2, 1)):
            if rc != 0:
                raise AssertionError(f"[14e] child resumed on {n} exited "
                                     f"{rc}: {err[-2000:]}")
        resumed = {}
        with np.load(out["clean"]) as a:
            want = a["fits"].tolist()
            for n in (2, 1):
                with np.load(out[f"resumed{n}"]) as r:
                    _, fac, fit = npz_diff(a, r)
                    ran, loads = r["sweeps"].tolist(), int(r["loads"])
                    fits = r["fits"].tolist()
                kept = np.array_equal(np.asarray(fits[:DIST_KILL_SWEEP]),
                                      np.asarray(snap.fits, np.float64))
                if ran != list(range(DIST_KILL_SWEEP, ALS_SWEEPS)) \
                        or loads != 1 or fit > FIT_ATOL or not kept \
                        or not all(f == f for f in fits):
                    raise AssertionError(f"[14e] resumed on {n}: sweeps "
                                         f"{ran}, loads {loads}, fits {fits}"
                                         f" vs clean {want}")
                resumed[n] = {"fits": fits, "fit_diff": fit,
                              "factor_diff": fac, "sweeps": ran}
    rep = obs.resilience_report()
    if rep["unanswered"]:
        raise AssertionError(f"[14e] unanswered faults {rep['unanswered']}")
    secs = time.perf_counter() - t0
    log(f"[14e] killed on 4 shards at sweep {DIST_KILL_SWEEP} (snapshots "
        f"{left}), resumed on 2 and on 1 shard: each loaded 1 snapshot, ran "
        f"sweeps {resumed[2]['sweeps']}, kept its fits bitwise and ended "
        f"within {resumed[2]['fit_diff']:.2e} / "
        f"{resumed[1]['fit_diff']:.2e} of the clean 4-shard run's fits; "
        f"[14e] took {secs:.1f} s")
    report["dist_resilience"] = {"clean_fits": clean, "rungs": rungs,
                                 "resumed": resumed, "seconds": secs}


def phase_dist(kmt, t, factors, small, twitch, report, reps):
    """[14] the distributed tier: [14a], [14b] and [14d] on nell1 0.1 (the
    nonzeros and factors of [3], whose fits and float64 witness [14b]
    holds the sharded run to), [14c] the other kernels on ``small``
    ([8]'s nell1 0.01 COO) and ``twitch`` ([5]'s COO), [14e] resilience
    on ``small``. Returns [14a]'s per-mode times, the launches of
    [14a]'s ``permute`` rotation and [14c]'s rotations by kernel, and
    [14a]'s kernel error."""
    t0 = time.perf_counter()
    times, launches, err = phase_dist_nell1(kmt, t, factors,
                                            report["nell1"], report, reps)
    launches = dict(launches)
    for row in phase_dist_more(kmt, small, twitch, report).values():
        for name, count in row["launches"].items():
            launches[name] = launches.get(name, 0) + count
    phase_dist_resilience(small, report)
    log(f"[14] took {time.perf_counter() - t0:.1f} s; kernels launched by "
        f"its driven rotations ([14a] permute, [14c]): {launches}")
    return times, launches, err


# --------------------------------------------------------------------------
# [15] The dense attention family and the CPD-factorized embedding.
# --------------------------------------------------------------------------
DENSE_ARCHS = ("tinyllama-1.1b", "olmo-1b", "qwen2.5-3b")
DENSE_BATCH, DENSE_SEQ = 4, 4096      # prefill_32k cut 8x in B and in S
DENSE_XCHECK_SEQ = 64
CPD_ARCH = "tinyllama-1.1b"


def first_layers(model, cfg4):
    """A model of ``cfg4.n_layers`` layers (and ``cfg4.n_enc_layers``
    encoder layers) over the first layers' parameter tensors of
    ``model`` (no copy)."""
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_of

    tree = tree_of(model)
    tree["layers"] = [tree["layers"][str(i)] for i in range(cfg4.n_layers)]
    if "enc" in tree:
        tree["enc"] = [tree["enc"][str(i)]
                       for i in range(cfg4.n_enc_layers)]
    small = transformer.Model(cfg4, tree)
    if next(small.parameters()).data_ptr() != \
            next(model.parameters()).data_ptr():
        raise AssertionError("the 4-layer model copied its parameters")
    return small


def dense_prefill(tag, model, cfg, tokens, reps, kernel="softmax",
                  **inputs):
    """The main path: one bf16 prefill ``forward`` (``inputs``: a
    ``vlm``'s ``embeds``, prepended, or an encoder-decoder's
    ``enc_embeds``), checked (shape, finite), then timed (median of
    ``reps`` CUDA-event runs) and profiled (matmul / ``kernel`` (softmax)
    / other device time)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.tensorized import split_dims

    width = (math.prod(split_dims(cfg.vocab_padded)) if cfg.cpd_embedding
             else cfg.vocab_padded)
    b, seq = tokens.shape
    seq += inputs["embeds"].shape[1] if "embeds" in inputs else 0
    out = {}

    def fwd():
        return transformer.forward(model, cfg, tokens, **inputs)

    with torch.no_grad():
        torch.cuda.reset_peak_memory_stats()
        logits = fwd()
        torch.cuda.synchronize()
        out["prefill_peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
        if logits.shape != (b, seq, width) or \
                not torch.isfinite(logits).all():
            raise AssertionError(f"{tag} forward logits "
                                 f"{tuple(logits.shape)} not finite or not "
                                 f"{(b, seq, width)}")
        del logits
        out["forward_ms"] = cuda_median_ms(fwd, reps, warm=False)
        out["forward_profile"] = device_breakdown(fwd, kernel)
    log(f"{tag} forward (B {b}, S {seq}, bf16, logits width {width}): "
        f"{out['forward_ms']:.1f} ms (median of {reps}), peak "
        f"{out['prefill_peak_gib']:.2f} GiB")
    log(f"{tag} forward profile: {breakdown_line(out['forward_profile'])}")
    return out


def dense_run(tag, cfg, reps, g):
    """Init at full width and depth, the prefill, the float32 cross-check
    on a 4-layer copy over the same tensors, and serving; returns the
    model and its numbers."""
    import dataclasses

    import torch
    from repro_torch.models import transformer

    free_device_memory()
    t0 = time.perf_counter()
    model = transformer.init_model(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    gib = sum(p.numel() * p.element_size()
              for p in model.parameters()) / 2**30
    log(f"{tag} {cfg.name}{' + CPD embedding' if cfg.cpd_embedding else ''}"
        f": {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads of "
        f"{cfg.hd} / {cfg.n_kv_heads} KV, d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab}, norm {cfg.norm}, qkv_bias {cfg.qkv_bias}, tied "
        f"{cfg.tie_embeddings}; {n_params:,} params ({gib:.2f} GiB f32; "
        f"param_count() {cfg.param_count():,}) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    tokens = torch.randint(0, cfg.vocab, (DENSE_BATCH, DENSE_SEQ),
                           generator=g, device="cuda")
    out = {"params": n_params, "param_gib": gib, "layers": cfg.n_layers,
           "batch": DENSE_BATCH, "seq": DENSE_SEQ,
           **dense_prefill(tag, model, cfg, tokens, reps)}
    del tokens
    cfg4 = dataclasses.replace(cfg, n_layers=4, compute_dtype="float32")
    prompt = torch.randint(0, cfg.vocab, (DENSE_BATCH, DENSE_XCHECK_SEQ),
                           generator=g, device="cuda")
    with torch.no_grad():
        xerr, xlogit = xcheck(tag, first_layers(model, cfg4), cfg4, prompt)
    out["xcheck_max_abs_diff"] = xerr
    out["xcheck_max_abs_logit"] = xlogit
    out.update(serve_check(tag, model, cfg, DENSE_BATCH, g, "softmax"))
    return model, out


def abs_limit(sides, terms, abs_sum):
    """``sides * LAMBDA * terms * u * abs_sum``: the float32 summation
    bound of the module docstring, ``terms`` the square roots and
    roundings it counts."""
    return sides * LAMBDA * terms * U * abs_sum


def cpd_checks(model, cfg, g):
    """[15b]'s checks of the CPD functions on the card, float32 (TF32
    off): the rows against the dense table's, the head against the dense
    table's product, and the three gradients of ``cpd_embed``'s own
    backward at the full batch against autograd through the naive lookup
    and a float64 recomputation, with the limit held against a backward
    that drops one token."""
    import torch
    from repro_torch.tensorized import (cpd_embed, cpd_logits, dense_table,
                                        split_dims)
    from repro_torch.tensorized.cpd_embedding import _krp, _lookup

    p = {k: getattr(model.embed_cpd, k).detach() for k in "ABC"}
    v1, v2 = split_dims(cfg.vocab_padded)
    rank, d = p["A"].shape[1], cfg.d_model
    tok = torch.randint(0, cfg.vocab, (DENSE_BATCH, DENSE_SEQ), generator=g,
                        device="cuda")
    n_tok = tok.numel()
    absp = {k: v.double().abs() for k, v in p.items()}
    i1, i2 = tok // v2, tok % v2
    out = {"v1": v1, "v2": v2, "rank": rank, "tokens": n_tok}

    # rows: cpd_embed == dense_table()[tokens]
    table = dense_table(p)
    rows = cpd_embed(p, tok)
    lim = abs_limit(2, math.sqrt(rank) + 2,
                    (absp["A"][i1] * absp["B"][i2]) @ absp["C"].T)
    out["rows_err"], share = close_to("[15b] cpd_embed rows vs "
                                      "dense_table()[tokens]", rows,
                                      table[tok], lim)
    log(f"[15b] cpd_embed at B {DENSE_BATCH} x S {DENSE_SEQ} == "
        f"dense_table()[tokens] (max err {out['rows_err']:.3e}, "
        f"{share:.3f} of the limit)")
    del rows, lim

    # the head: cpd_logits(x)[..., :vocab] == (x @ dense_table().T)
    x = torch.randn((DENSE_BATCH, 256, d), generator=g, device="cuda")
    krp_abs = _krp(absp["A"], absp["B"])
    got = cpd_logits(p, x)[..., :cfg.vocab]
    want = (x @ table.T)[..., :cfg.vocab]
    lim = abs_limit(2, math.sqrt(d) + math.sqrt(rank) + 2,
                    (x.double().abs() @ absp["C"]) @ krp_abs[:cfg.vocab].T)
    out["logits_err"], share = close_to("[15b] cpd_logits vs x @ "
                                        "dense_table().T", got, want, lim)
    log(f"[15b] cpd_logits (x {tuple(x.shape)}, {v1 * v2} ids) == x @ "
        f"dense_table().T on the first {cfg.vocab} (max err "
        f"{out['logits_err']:.3e}, {share:.3f} of the limit)")
    del x, krp_abs, got, want, lim, table

    # the spMTTKRP backward at the full batch
    gy = torch.randn((DENSE_BATCH, DENSE_SEQ, d), generator=g,
                     device="cuda")
    out["grad_err"], out["grad_share"] = cpd_grad_check("[15b]", p, tok, gy)

    def step(fn):
        def run():
            leaves = {k: v.clone().requires_grad_(True)
                      for k, v in p.items()}
            fn(leaves).backward(gy)
        return run

    def own(q):
        return cpd_embed(q, tok)

    def naive(q):
        return _lookup(q["A"], q["B"], q["C"], tok)[0]

    out["fwd_bwd_ms"] = cuda_median_ms(step(own), 5)
    out["naive_fwd_bwd_ms"] = cuda_median_ms(step(naive), 5)
    log(f"[15b] cpd_embed forward + backward at {n_tok:,} tokens: "
        f"{out['fwd_bwd_ms']:.3f} ms (autograd through the naive lookup "
        f"{out['naive_fwd_bwd_ms']:.3f}; median of 5)")
    return out


def cpd_grad_check(tag, p, tok, gy):
    """``cpd_embed``'s three gradients (its own backward, the spMTTKRP of
    the token batch ``tok`` with the cotangent ``gy``) against autograd
    through the naive lookup and a float64 recomputation, float32 (TF32
    off), with the limit held against a backward that drops the first
    token's cotangent; returns the errors and the largest shares of the
    limit."""
    import torch
    from repro_torch.tensorized import cpd_embed
    from repro_torch.tensorized.cpd_embedding import _lookup

    v1, v2 = p["A"].shape[0], p["B"].shape[0]
    rank, d = p["A"].shape[1], p["C"].shape[0]
    n_tok = tok.numel()
    absp = {k: v.double().abs() for k, v in p.items()}
    i1, i2 = tok // v2, tok % v2

    def grads(fn, dtype=torch.float32, cot=gy):
        leaves = {k: v.to(dtype, copy=True).requires_grad_(True)
                  for k, v in p.items()}
        fn(leaves).backward(cot.to(dtype))
        return [leaves[k].grad for k in "ABC"]

    def own(q):
        return cpd_embed(q, tok)

    def naive(q):
        return _lookup(q["A"], q["B"], q["C"], tok)[0]

    mine, auto = grads(own), grads(naive)
    f64 = grads(naive, torch.float64)
    ga = gy.double().abs()
    gc_abs = (ga.reshape(n_tok, d) @ absp["C"])
    a_abs, b_abs = absp["A"][i1].reshape(n_tok, rank), \
        absp["B"][i2].reshape(n_tok, rank)
    n1 = torch.bincount(i1.flatten(), minlength=v1).double()[:, None]
    n2 = torch.bincount(i2.flatten(), minlength=v2).double()[:, None]
    abs_sums = [
        torch.zeros_like(absp["A"]).index_add_(0, i1.flatten(),
                                               b_abs * gc_abs),
        torch.zeros_like(absp["B"]).index_add_(0, i2.flatten(),
                                               a_abs * gc_abs),
        ga.reshape(n_tok, d).T @ (a_abs * b_abs)]
    terms = [n1.sqrt() + math.sqrt(d) + 3, n2.sqrt() + math.sqrt(d) + 3,
             math.sqrt(n_tok) + 2]
    del gc_abs, a_abs, b_abs
    errs, shares = {}, {}
    for k, m, a, w, s, t in zip("ABC", mine, auto, f64, abs_sums, terms):
        e1, s1 = close_to(f"{tag} d{k} own backward vs float64", m, w,
                          abs_limit(1, t, s))
        e2, s2 = close_to(f"{tag} d{k} naive autograd vs float64", a, w,
                          abs_limit(1, t, s))
        e3, s3 = close_to(f"{tag} d{k} own backward vs naive autograd", m,
                          a, abs_limit(2, t, s))
        errs[k] = {"vs_f64": e1, "naive_vs_f64": e2, "vs_naive": e3}
        shares[k] = max(s1, s2, s3)
    dropped = gy.clone()
    dropped.view(-1, d)[0] = 0
    bad = grads(own, cot=dropped)
    if not any(((b.double() - w).abs() > abs_limit(1, t, s)).any()
               for b, w, s, t in zip(bad, f64, abs_sums, terms)):
        raise AssertionError(f"{tag} the gradient limit does not catch a "
                             "backward that drops one token")
    log(f"{tag} cpd_embed backward at {n_tok:,} tokens, D {d}, R {rank}: "
        "dA, dB, dC == autograd through the naive lookup and == float64 "
        "(shares of the limit " + ", ".join(
            f"d{k} {v:.3f}" for k, v in shares.items()) +
        "); a backward with one token dropped fails it")
    return errs, shares


def phase_dense(report, reps):
    """[15] The dense attention family at full width and depth
    (tinyllama-1.1b, olmo-1b, qwen2.5-3b; [15a]) and tinyllama-1.1b with
    the CPD-factorized embedding ([15b])."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(15)
    dense = {}
    for arch in DENSE_ARCHS:
        model, dense[arch] = dense_run("[15a]", get_config(arch), reps, g)
        del model
    report["dense"] = dense

    cfg = dataclasses.replace(get_config(CPD_ARCH), cpd_embedding=True)
    model, cpd = dense_run("[15b]", cfg, reps, g)
    cpd.update(cpd_checks(model, cfg, g))
    del model
    base = dense[CPD_ARCH]
    emb = (cpd["v1"] + cpd["v2"] + cfg.d_model) * cpd["rank"]
    table = cfg.vocab_padded * cfg.d_model
    cpd.update(embedding_params=emb, dense_table_params=table)
    log(f"[15b] embedding {emb:,} values ({cpd['v1']} + {cpd['v2']} + "
        f"{cfg.d_model}) x {cpd['rank']} against {table:,} dense: "
        f"{table / emb:.0f}x fewer; model {cpd['params']:,} params against "
        f"{base['params']:,} (no untied head)")
    log(f"[15b] beside the dense {CPD_ARCH}: prefill "
        f"{cpd['forward_ms']:.1f} / {base['forward_ms']:.1f} ms, decode "
        f"{cpd['serve'][1]['ms_per_step']:.2f} / "
        f"{base['serve'][1]['ms_per_step']:.2f} ms a step, peak "
        f"{cpd['prefill_peak_gib']:.2f} / "
        f"{base['prefill_peak_gib']:.2f} GiB")
    report["cpd_embedding"] = cpd
    free_device_memory()
    log(f"[15] passed in {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# [16] Training on the card.
# --------------------------------------------------------------------------
TRAIN_ARCH = "tinyllama-1.1b"
TRAIN_BATCH, TRAIN_SEQ = 4, 4096       # train_4k, the batch cut 256 -> 4
TRAIN_STEPS = 2                        # [16a]/[16b], cut from 4 for time
GRAD_LAYERS, GRAD_SEQ = 4, 256         # [16a]'s float32 card-vs-CPU step
GRAD_RTOL = 1e-3                       # of each leaf's largest gradient
GRAD_ZERO = 1e-6                       # a leaf's largest, at least: x the
#                                        step's largest (zero gradients)
CPD_SMOKE_STEPS = 15
RWKV_TRAIN_BATCH, RWKV_TRAIN_STEPS = 2, 3
RG_TRAIN_LAYERS, RG_TRAIN_BATCH, RG_TRAIN_STEPS = 6, 2, 3
CTRL_LAYERS, CTRL_BATCH, CTRL_SEQ = 2, 2, 1024
CTRL_STEPS, CTRL_FAIL = 4, 2
SOURCES["wkv6_bwd"] = CSRC + "wkv6_bwd.cu"
SOURCES["lru_scan_bwd"] = CSRC + "lru_scan.cu"
# no TPU kernel: the function whose jax-autodiff gradient they compute
REPLACES["wkv6_bwd"] = ("src/repro/models/rwkv.py:89 (no TPU kernel: the "
                        "gradient of time_mix's chunked jnp algebra, by jax "
                        "autodiff)")
REPLACES["lru_scan_bwd"] = ("src/repro/models/rglru.py:73 (no TPU kernel: "
                            "the gradient of apply_rglru's associative "
                            "scan, by jax autodiff)")


def train_ocfg(steps):
    """``launch.train``'s optimizer: AdamW, lr 3e-4, one warm-up step."""
    from repro_torch.training import OptimizerConfig

    return OptimizerConfig(total_steps=steps, warmup_steps=1)


def train_run(tag, cfg, batch, seq, steps, prepare=None, profile=None,
              ocfg=None):
    """The main path: ``init_state`` on the card from seed 0 (``prepare``
    may edit its params), then ``steps`` of ``make_train_step`` (with
    ``ocfg``, by default :func:`train_ocfg`'s AdamW) on
    ``SyntheticLM`` batches, each timed on the host clock around a
    synchronised step, the kernels' launch counts zeroed just before and
    read just after; given ``profile`` (kernel names for
    :func:`device_breakdown`), one more step under ``torch.profiler``.
    Returns the state and its numbers."""
    import statistics

    import torch
    from repro_torch.kernels import lru_scan as klru
    from repro_torch.kernels import wkv6 as kw6
    from repro_torch.training import SyntheticLM, init_state, make_train_step
    from repro_torch.training.tree import leaves

    free_device_memory()
    ocfg = ocfg or train_ocfg(steps)
    t0 = time.perf_counter()
    state = init_state(cfg, ocfg, 0, device="cuda")
    if prepare is not None:
        prepare(state)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in leaves(state["params"]))
    log(f"{tag} {cfg.name}{' + CPD embedding' if cfg.cpd_embedding else ''}"
        f": {cfg.n_layers} layers, d {cfg.d_model}, remat {cfg.remat}, "
        f"{n_params:,} params ({ocfg.name}; f32 params and grads "
        f"{8 * n_params / 1e9:.1f} GB"
        + (f", m, v {8 * n_params / 1e9:.1f} GB" if ocfg.name == "adamw"
           else "") + f") initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    data = SyntheticLM(cfg, batch, seq, seed=0, device="cuda")
    step = make_train_step(cfg, ocfg)
    out = {"params": n_params, "batch": batch, "seq": seq, "steps": steps,
           "step_ms": [], "losses": [], "grad_norms": []}
    torch.cuda.reset_peak_memory_stats()
    kw6.reset_launch_counts()
    klru.reset_launch_counts()
    for _ in range(steps):
        b = data.next()
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        out["step_ms"].append(1e3 * (time.perf_counter() - t1))
        out["losses"].append(float(m["loss"]))
        out["grad_norms"].append(float(m["grad_norm"]))
    out["launches"] = {**kw6.LAUNCHES, **klru.LAUNCHES}
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    if not all(math.isfinite(x) for x in out["losses"] + out["grad_norms"]):
        raise AssertionError(f"{tag} non-finite loss or grad norm: "
                             f"{out['losses']}, {out['grad_norms']}")
    out["steady_step_ms"] = statistics.median(out["step_ms"][1:])
    out["tokens_per_s"] = batch * seq / (out["steady_step_ms"] / 1e3)
    log(f"{tag} {steps} steps at B {batch}, S {seq}: step ms "
        + ", ".join(f"{x:.1f}" for x in out["step_ms"]) +
        f" (median after the first {out['steady_step_ms']:.1f}, "
        f"{out['tokens_per_s']:,.0f} tokens/s), peak "
        f"{out['peak_gib']:.2f} GiB, losses "
        + ", ".join(f"{x:.4f}" for x in out["losses"]))
    if profile is not None:
        b = data.next()
        held = {}

        def one():
            held["state"], _ = step(state, b)

        out["profile"] = device_breakdown(one, profile)
        state = held.pop("state")
        log(f"{tag} one more step under torch.profiler: "
            + breakdown_line(out["profile"]))
    return state, out


def first_layers_params(params, n):
    """The stage-layout params of a one-block-pattern model cut to its
    first ``n`` layers, and its encoder to its first ``n`` (the tensors
    shared)."""
    from repro_torch.training.tree import tree_map

    return {k: tree_map(lambda leaf: leaf[:n], v)
            if k.startswith("stage") or k == "enc" else v
            for k, v in params.items()}


def _tree_copy(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_copy(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_copy(v, device) for v in tree]
    return tree.detach().to(device, copy=True)


def leaf_limit(rtol, w, top):
    """``rtol`` x the leaf ``w``'s largest |element|, that at least
    ``GRAD_ZERO`` x ``top`` (the step's largest gradient element): a
    leaf whose gradient is zero but for float32 rounding (a key bias: a
    softmax does not change when one vector is added to every key) is
    held to the rounding of the sums it comes from, not to itself."""
    return rtol * max(float(w.abs().max()), GRAD_ZERO * top) + 1e-30


def grad_leaf_check(tag, got, want):
    """Per leaf ``max |got - want| <=`` :func:`leaf_limit` at
    ``GRAD_RTOL`` (float32 gradients of one step, card against CPU);
    returns the largest share of a leaf's limit, or raises naming the
    leaf."""
    worst = 0.0
    top = max(float(w.abs().max()) for w in want)
    for i, (g, w) in enumerate(zip(got, want)):
        lim = leaf_limit(GRAD_RTOL, w, top)
        err = float((g.cpu() - w).abs().max())
        if not err <= lim:
            raise AssertionError(f"{tag} gradient leaf {i} "
                                 f"{tuple(w.shape)} off by {err:.3e} "
                                 f"(limit {lim:.3e})")
        worst = max(worst, err / lim)
    return worst


def train_grad_check(tag, cfg, state, layers=GRAD_LAYERS, seq=GRAD_SEQ):
    """A float32 copy (TF32 off) of the first ``layers`` layers takes
    one step (B 1, S ``seq``) on the card and on the CPU from the same
    state: every
    gradient leaf (recovered from the first moment, m = (1 - b1) g after
    one step) within ``GRAD_RTOL`` of the leaf's largest, the losses
    within 1e-4; the check must fail when one layer's gradient is
    dropped."""
    import dataclasses

    import torch
    from repro_torch.training import (SyntheticLM, make_train_step,
                                      optimizer)
    from repro_torch.training.tree import leaves, tree_map

    cfg4 = dataclasses.replace(cfg, n_layers=layers,
                               n_enc_layers=min(cfg.n_enc_layers, layers),
                               compute_dtype="float32")
    ocfg = train_ocfg(1)
    batch = SyntheticLM(cfg4, 1, seq, seed=1, device="cpu").next()
    outs = {}
    for dev in ("cuda", "cpu"):
        params = _tree_copy(first_layers_params(state["params"], layers),
                            dev)
        st = {"params": params, "opt": optimizer.init(params, ocfg),
              "step": torch.zeros((), dtype=torch.int32)}
        new, m = make_train_step(cfg4, ocfg)(
            st, {k: v.to(dev) for k, v in batch.items()})
        outs[dev] = (float(m["loss"]), new["opt"]["m"])
    (lc, got), (lw, want) = outs["cuda"], outs["cpu"]
    if abs(lc - lw) > 1e-4 * abs(lw):
        raise AssertionError(f"{tag} float32 loss {lc} on the card, {lw} on "
                             "the CPU")
    share = grad_leaf_check(tag, leaves(got), leaves(want))
    tree_map(lambda leaf: leaf[1].zero_(), got["stage0"])   # layer 1's
    try:
        grad_leaf_check(tag, leaves(got), leaves(want))
    except AssertionError:
        pass
    else:
        raise AssertionError(f"{tag} the gradient check does not catch a "
                             "step that drops one layer's gradient")
    log(f"{tag} float32 step of {layers} layers (B 1, S {seq}, "
        f"TF32 off) on the card == on the CPU: {len(leaves(want))} "
        f"gradient leaves (max {share:.3f} of the limit {GRAD_RTOL} x the "
        f"leaf's largest), loss {lc:.6f} / {lw:.6f}; dropping layer 1's "
        "gradients fails it")
    return {"grad_share": share, "loss_card": lc, "loss_cpu": lw}


def embed_cotangent(cfg, state, batch):
    """The cotangent that reaches the CPD embedding's output in one
    backward of the loss at ``batch`` (f32, the factors' dtype)."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.training import make_loss_fn
    from repro_torch.training.tree import leaves, unflatten

    seen = []
    embed = transformer.cpd_embed

    def hooked(p, ids):
        out = embed(p, ids)
        out.register_hook(seen.append)
        return out

    req = [x.detach().requires_grad_(True) for x in leaves(state["params"])]
    transformer.cpd_embed = hooked
    try:
        loss = make_loss_fn(cfg)(transformer.unstack_layers(
            cfg, unflatten(state["params"], req)), batch)
        torch.autograd.grad(loss, req)
    finally:
        transformer.cpd_embed = embed
    return seen[0]


def train_cpd(tag, cfg):
    """[16b]: the CPD tinyllama's steps, its factor gradients at the last
    training batch against float64, and a loss-decrease run at the smoke
    config on the card (the reference's
    ``test_cpd_embedding_inside_model_trains``)."""
    import dataclasses

    import numpy as np
    from repro_torch.configs import smoke
    from repro_torch.training import (OptimizerConfig, SyntheticLM,
                                      init_state, make_train_step)

    state, out = train_run(tag, cfg, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS)
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device="cuda")
    data.set_state({"step": TRAIN_STEPS - 1})
    batch = data.next()
    gy = embed_cotangent(cfg, state, batch)
    p = {k: v.detach() for k, v in state["params"]["embed_cpd"].items()}
    del state
    free_device_memory()
    out["grad_err"], out["grad_share"] = cpd_grad_check(
        tag, p, batch["tokens"], gy)
    del gy, p

    scfg = dataclasses.replace(smoke(CPD_ARCH), cpd_embedding=True,
                               cpd_rank=16)
    ocfg = OptimizerConfig(lr=3e-3, warmup_steps=2, total_steps=20)
    st = init_state(scfg, ocfg, 0, device="cuda")
    step = make_train_step(scfg, ocfg)
    sdata = SyntheticLM(scfg, batch=4, seq=32, seed=0, device="cuda")
    losses = []
    for _ in range(CPD_SMOKE_STEPS):
        st, m = step(st, sdata.next())
        losses.append(float(m["loss"]))
    first, last = np.mean(losses[:3]), np.mean(losses[-3:])
    if not last < first:
        raise AssertionError(f"{tag} smoke CPD loss did not decrease: "
                             f"{losses}")
    out["smoke_losses"] = losses
    log(f"{tag} smoke CPD (rank 16) {CPD_SMOKE_STEPS} steps on the card: "
        f"mean loss of the first 3 {first:.4f} -> last 3 {last:.4f}")
    return out


def wkv_bwd_limit(kw6, args, dy, sides=1):
    """Per-element limit of the float32 WKV backward against float64: the
    same backward on ``|r|, |k|, w, |v|, |u|, |dy|`` (float64), ``A``,
    bounds every partial sum; the state and its gradient each carry a
    random walk of ~2 sqrt(T) roundings, a readout sums K terms, and the
    bonus terms add ~4 roundings: ``sides * LAMBDA * (2 sqrt(T) +
    sqrt(K) + 4) * u * A``."""
    t, kd = args[0].shape[1], args[0].shape[2]
    absd = [x.double().abs() for x in (*args, dy)]
    absd[2] = args[2].double()
    return [sides * LAMBDA * (2 * math.sqrt(t) + math.sqrt(kd) + 4) * U * a
            for a in kw6.wkv6_backward_plain(*absd)]


def wkv_bwd_check(kw6, args, dy, tag):
    """The backward kernel against the float64 plain backward within the
    limit, every output; the limit held against a run whose walks drop
    their carry at step T / 2 (w zeroed there). Returns (max error, its
    share of the limit)."""
    names = ("dr", "dk", "dw", "dv", "du")
    want = kw6.wkv6_backward_plain(*(x.double() for x in (*args, dy)))
    lims = wkv_bwd_limit(kw6, args, dy)
    got = kw6.wkv6_backward(*args, dy)
    err = share = 0.0
    for n, g, w, lim in zip(names, got, want, lims):
        e, s = close_to(f"{tag} wkv6_bwd {n}", g, w, lim)
        err, share = max(err, e), max(share, s)
    w_drop = args[2].clone()
    w_drop[:, args[2].shape[1] // 2] = 0
    bad = kw6.wkv6_backward(args[0], args[1], w_drop, *args[3:], dy)
    if not any(((b.double() - w).abs() > lim).any()
               for b, w, lim in zip(bad, want, lims)):
        raise AssertionError(f"{tag} wkv6_bwd: the limit does not catch a "
                             "backward that drops its carry at one step")
    return err, share


def wkv_bwd_bound(args):
    """``(bytes, flops)`` the WKV backward must move and do
    (``kernels.wkv6.wkv6_bwd_cost``, which the dry-run charges too)."""
    from repro_torch.kernels import wkv6 as kw6

    return kw6.wkv6_bwd_cost(*args[0].shape, args[3].shape[-1])


def bwd_record(name, rec, per):
    """A backward kernel's entry of the ``kernels`` JSON line (with the
    same numbers at a second shape under ``train_step``, where timed)."""
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
            "shape")
    out = {"name": name, "route": "cuda", "source": SOURCES[name],
           "replaces": REPLACES[name], "launches": rec["launches"],
           "max_abs_err": rec["max_abs_err"], "ms": rec["ms"],
           "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
           "bound_by": rec["bound_by"], "library_ms": None, "per": per}
    if "train_step" in rec:
        out["train_step"] = {k: rec["train_step"][k] for k in keys}
    return out


def kernel_timing(fn, plain, nbytes, flops, reps):
    """CUDA-event ms of the kernel (mean of ``reps``) and of its plain
    version (one), beside the bound."""
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * flops / F32_FLOP_PER_S
    return {"ms": cuda_ms(fn, reps), "plain_ms": cuda_ms(plain, 1),
            "bytes": nbytes, "flops": flops,
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def layer0_input(cfg, state, batch, seq, seed):
    """Layer 0's normed input at a (batch, seq) draw of ``SyntheticLM``,
    and the draw's tokens."""
    import torch
    from repro_torch.models import transformer
    from repro_torch.models.common import apply_norm
    from repro_torch.training import SyntheticLM

    view = transformer.unstack_layers(cfg, state["params"])
    tok = SyntheticLM(cfg, batch, seq, seed=seed,
                      device="cuda").next()["tokens"]
    with torch.no_grad():
        x0 = apply_norm(view.layers[0].ln1,
                        transformer.embed_lookup(view, tok, cfg), cfg)
    return view.layers[0], x0


def train_rwkv(tag, kw6, reps):
    """[16c]: rwkv6-3b at full width and depth (``wb_lora`` drawn non-zero
    as in [10]) and a profiled step, then ``wkv6_bwd`` at layer 0's
    prefill shape (B 4, S 4096: BH 160) and at its training shape (B 2:
    BH 80) against the plain backward, timed."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import rwkv

    cfg = get_config(RWKV_ARCH)
    state, out = train_run(tag, cfg, RWKV_TRAIN_BATCH, TRAIN_SEQ,
                           RWKV_TRAIN_STEPS, draw_wb_lora,
                           profile=("wkv6_bwd", "wkv6"))
    want = {"wkv6": 2 * cfg.n_layers * RWKV_TRAIN_STEPS,
            "wkv6_bwd": cfg.n_layers * RWKV_TRAIN_STEPS}
    got = {k: out["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"{tag} launches {got}, expected {want} "
                             "(forward, recompute and backward a layer)")
    log(f"{tag} launches over {RWKV_TRAIN_STEPS} steps: wkv6 "
        f"{got['wkv6']} (forward + recompute), wkv6_bwd {got['wkv6_bwd']}")
    layer, x0 = layer0_input(cfg, state, RWKV_BATCH, RWKV_SEQ, 2)
    _, x0_train = layer0_input(cfg, state, RWKV_TRAIN_BATCH, TRAIN_SEQ, 4)
    del state
    free_device_memory()
    with torch.no_grad():
        cases = [rwkv.wkv_inputs(layer, x, cfg)[:5] for x in (x0, x0_train)]
    del layer, x0, x0_train
    recs = []
    for i, args in enumerate(cases):
        dy = torch.randn(args[3].shape, device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(3 + i))
        err, share = wkv_bwd_check(kw6, args, dy, tag)
        rec = kernel_timing(lambda: kw6.wkv6_backward(*args, dy),
                            lambda: kw6.wkv6_backward_plain(*args, dy),
                            *wkv_bwd_bound(args), reps)
        rec.update(max_abs_err=err, launches=got["wkv6_bwd"],
                   shape=list(args[0].shape) + [args[3].shape[-1]])
        log(f"{tag} wkv6_bwd at layer 0 (BH {args[0].shape[0]}, T "
            f"{args[0].shape[1]}, 64, 64) == float64 plain (max err "
            f"{err:.3e}, {share:.3f} of the limit); a carry dropped at T / "
            f"2 fails it: {rec['ms']:.3f} ms a launch (plain "
            f"{rec['plain_ms']:.1f}, bound {rec['bound_ms']:.4f} by "
            f"{rec['bound_by']})")
        recs.append(rec)
        del dy
    out["wkv6_bwd"] = {**recs[0], "train_step": recs[1]}
    del cases
    free_device_memory()
    return out


def lru_bwd_check(klru, a, h, dh, tag):
    """The backward kernel against the float64 plain backward within
    ``LAMBDA * (2 sqrt(T - t) + 3) * u * A`` (``A`` the same on ``|a|,
    |h|, |dh|``: the reverse scan's state carries a random walk of ~2
    sqrt(T - t) roundings, da one more); the limit held against a run
    that drops the carry at step T / 2 (a zeroed there)."""
    import torch

    t = a.shape[1]
    want = klru.lru_scan_backward_plain(a.double(), h.double(), dh.double())
    steps = (t - torch.arange(t, device=a.device, dtype=torch.float64))
    scale = LAMBDA * (2 * steps.sqrt() + 3)[None, :, None] * U
    lims = [scale * x for x in klru.lru_scan_backward_plain(
        a.double().abs(), h.double().abs(), dh.double().abs())]
    got = klru.lru_scan_backward(a, h, dh)
    err = share = 0.0
    for n, g, w, lim in zip(("da", "dx"), got, want, lims):
        e, s = close_to(f"{tag} lru_scan_bwd {n}", g, w, lim)
        err, share = max(err, e), max(share, s)
    a_drop = a.clone()
    a_drop[:, t // 2] = 0
    bad = klru.lru_scan_backward(a_drop, h, dh)
    if not any(((b.double() - w).abs() > lim).any()
               for b, w, lim in zip(bad, want, lims)):
        raise AssertionError(f"{tag} lru_scan_bwd: the limit does not "
                             "catch a backward that drops one carry")
    return err, share


def train_rg(tag, klru, reps):
    """[16d]: recurrentgemma-9b at full width, depth cut to
    ``RG_TRAIN_LAYERS`` (two cycles of rec, rec, local), then
    ``lru_scan_bwd`` at layer 0's prefill shape (4, 4096, 4096) against
    the plain backward, timed."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import rglru

    cfg = dataclasses.replace(get_config(RG_ARCH), n_layers=RG_TRAIN_LAYERS)
    state, out = train_run(tag, cfg, RG_TRAIN_BATCH, TRAIN_SEQ,
                           RG_TRAIN_STEPS)
    n_rec = sum(kind == "rec" for pat, rep in cfg.stages()
                for _ in range(rep) for kind in pat)
    want = {"lru_scan": 2 * n_rec * RG_TRAIN_STEPS,
            "lru_scan_bwd": n_rec * RG_TRAIN_STEPS}
    got = {k: out["launches"][k] for k in want}
    if got != want:
        raise AssertionError(f"{tag} launches {got}, expected {want}")
    log(f"{tag} launches over {RG_TRAIN_STEPS} steps: lru_scan "
        f"{got['lru_scan']} (forward + recompute), lru_scan_bwd "
        f"{got['lru_scan_bwd']}")
    layer, x0 = layer0_input(cfg, state, RG_BATCH, RG_SEQ, 2)
    del state
    free_device_memory()
    with torch.no_grad():
        a, b, _ = rglru.scan_inputs(layer.rec, x0, cfg)
        h = klru.lru_scan(a, b)
    del layer, x0, b
    dh = torch.randn(a.shape, device="cuda",
                     generator=torch.Generator(device="cuda").manual_seed(4))
    err, share = lru_bwd_check(klru, a, h, dh, tag)
    rec = kernel_timing(lambda: klru.lru_scan_backward(a, h, dh),
                        lambda: klru.lru_scan_backward_plain(a, h, dh),
                        *klru.lru_scan_bwd_cost(*a.shape), reps)
    rec.update(max_abs_err=err, launches=got["lru_scan_bwd"])
    log(f"{tag} lru_scan_bwd at layer 0 {tuple(a.shape)} == float64 plain "
        f"(max err {err:.3e}, {share:.3f} of the limit); a dropped carry "
        f"fails it: {rec['ms']:.3f} ms a launch (plain "
        f"{rec['plain_ms']:.1f}, bound {rec['bound_ms']:.4f} by "
        f"{rec['bound_by']})")
    out["lru_scan_bwd"] = rec
    del a, h, dh
    free_device_memory()
    return out


def train_controller(tag):
    """[16e]: ``TrainController`` on the card (tinyllama-1.1b at full
    width, ``CTRL_LAYERS`` layers): preempted at step ``CTRL_FAIL`` of
    ``CTRL_STEPS`` and resumed from its checkpoint by a fresh controller,
    against an uninterrupted run (not bitwise on the card: the
    embedding's backward accumulates with atomics); then one checkpoint
    saved and loaded, timed."""
    import dataclasses
    import os
    import tempfile

    import torch
    from repro_torch.configs import get_config
    from repro_torch.training import (CheckpointManager, ControllerConfig,
                                      SyntheticLM, TrainController)
    from repro_torch.training.tree import leaves

    free_device_memory()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=CTRL_LAYERS)
    ocfg = train_ocfg(CTRL_STEPS)

    def controller(d):
        ctrl = ControllerConfig(ckpt_dir=d, ckpt_every=CTRL_FAIL, keep=2,
                                async_save=False)
        return TrainController(cfg, ocfg, ctrl, SyntheticLM(
            cfg, CTRL_BATCH, CTRL_SEQ, seed=0, device="cuda"),
            device="cuda")

    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        clean, cm = controller(os.path.join(tmp, "clean")).run(CTRL_STEPS)
        tc = controller(os.path.join(tmp, "pre"))
        try:
            tc.run(CTRL_STEPS, fail_at=CTRL_FAIL)
        except InterruptedError:
            pass
        else:
            raise AssertionError(f"{tag} the preemption did not fire")
        del tc
        tc2 = controller(os.path.join(tmp, "pre"))
        if int(tc2.state["step"]) != CTRL_FAIL or tc2.data.step != CTRL_FAIL:
            raise AssertionError(f"{tag} resumed at step "
                                 f"{int(tc2.state['step'])}, data "
                                 f"{tc2.data.step}, not {CTRL_FAIL}")
        resumed, rm = tc2.run(CTRL_STEPS)
        diff = max(float((a - b).abs().max()) for a, b in zip(
            leaves(resumed["params"]), leaves(clean["params"])))
        bitwise = all(torch.equal(a, b) for a, b in zip(
            leaves(resumed), leaves(clean)))
        lim = 2 * ocfg.lr * (CTRL_STEPS - CTRL_FAIL)
        if not diff <= lim or abs(float(rm["loss"]) - float(cm["loss"])) \
                > 1e-3 * abs(float(cm["loss"])):
            raise AssertionError(f"{tag} resumed run off the clean one: "
                                 f"params {diff:.3e} (limit {lim:.1e}), "
                                 f"loss {float(rm['loss'])} / "
                                 f"{float(cm['loss'])}")
        mgr = CheckpointManager(os.path.join(tmp, "timed"), keep=1,
                                async_save=False)
        t0 = time.perf_counter()
        mgr.save(resumed, tc2.data.get_state())
        out["save_ms"] = 1e3 * (time.perf_counter() - t0)
        t0 = time.perf_counter()
        back, _ = mgr.restore_latest(like=clean)
        torch.cuda.synchronize()
        out["load_ms"] = 1e3 * (time.perf_counter() - t0)
        nbytes = sum(x.numel() * x.element_size() for x in leaves(resumed))
        if not all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                     leaves(resumed))):
            raise AssertionError(f"{tag} a checkpoint did not load back "
                                 "bitwise")
    out.update(params_max_diff=diff, bitwise=bitwise, state_bytes=nbytes,
               loss_clean=float(cm["loss"]), loss_resumed=float(rm["loss"]))
    log(f"{tag} TrainController ({cfg.name}, {CTRL_LAYERS} layers, B "
        f"{CTRL_BATCH}, S {CTRL_SEQ}): preempted at step {CTRL_FAIL} of "
        f"{CTRL_STEPS}, resumed from its checkpoint: params within "
        f"{diff:.3e} of an uninterrupted run (limit {lim:.1e}; bitwise "
        f"{bitwise}), loss {out['loss_resumed']:.6f} / "
        f"{out['loss_clean']:.6f}; a checkpoint of {nbytes / 1e9:.2f} GB "
        f"saved in {out['save_ms']:.0f} ms, loaded in "
        f"{out['load_ms']:.0f} ms")
    return out


def phase_train(kw6, klru, report, reps):
    """[16] Training on the card: tinyllama-1.1b ([16a]) and its CPD
    variant ([16b]) at full width and depth, rwkv6-3b at full width and
    depth ([16c]), recurrentgemma-9b at full width on 6 layers ([16d]),
    the controller ([16e]). Returns the two backward kernels' records."""
    import dataclasses

    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    out = {}
    cfg = get_config(TRAIN_ARCH)
    state, out["tinyllama"] = train_run("[16a]", cfg, TRAIN_BATCH,
                                        TRAIN_SEQ, TRAIN_STEPS)
    out["tinyllama"].update(train_grad_check("[16a]", cfg, state))
    del state
    out["cpd"] = train_cpd("[16b]", dataclasses.replace(
        cfg, cpd_embedding=True))
    out["rwkv"] = train_rwkv("[16c]", kw6, reps)
    out["rg"] = train_rg("[16d]", klru, reps)
    out["controller"] = train_controller("[16e]")
    report["train"] = out
    free_device_memory()
    log(f"[16] passed in {time.perf_counter() - t0:.1f} s")
    return out["rwkv"]["wkv6_bwd"], out["rg"]["lru_scan_bwd"]


# --------------------------------------------------------------------------
# [17] Sharded training on the card.
# --------------------------------------------------------------------------
SHARD_MESH = (2, 2)                    # (data, model), 4 shards on cuda:0
SHARD_STEPS = 1                        # [17a]'s timed steps after the check
SHARD_LAYERS = 11                      # [17a]'s depth (of 22), for time
SHARD_LOSS_ATOL = 3e-2                 # the reference's bf16 loss bound
SHARD_GRAD_RTOL = 5e-2                 # bf16: of each leaf's largest
SHARD_PARAM_ATOL = 1e-6                # x max(1, |p|) where g's sign is sure
SHARD_G_FLOOR = 1e-5                   # |g| above it: eps out of the step
SHARD_F32_LAYERS, SHARD_F32_SEQ = 2, 256
SHARD_REC_LAYERS = 4                   # [17b]'s depth, each model
SHARD_REC_HOOKS = {"rwkv6-3b": "sum_tmix",       # [17b]'s float32 mutants
                   "recurrentgemma-9b": "sum_rec"}
SHARD_ROUND_K = 5                      # [17b]: a bf16 leaf's limit is at
#                                        least this x how far bf16 rounding
#                                        moves the single-device step's leaf
PIPE_D, PIPE_BATCH, PIPE_MICRO = 1024, 64, 8
COMPRESS_SHAPE, COMPRESS_RANK = (4096, 1024), 32


def shard_ctx(shape):
    """A sharding context over ``shape`` (data, model) shards, all on
    ``cuda:0`` (a single controller: times are "shards on one card")."""
    from repro_torch import sharding

    axes = ("data", "model")[:len(shape)]
    return sharding.make_ctx(dist_mesh(math.prod(shape), shape, axes))


def shard_step_pair(tag, cfg, ctx, batch, prepare=None, rtol=GRAD_RTOL,
                    loss_atol=None, rounding=None):
    """One step from the same state and batch on one device and sharded
    over ``ctx`` (the state placed by a copy before
    the single-device step updates it in place): the losses within
    ``loss_atol`` (else 1e-4 relative), every gradient leaf (the first
    moment, m = (1 - b1) g) within ``rtol`` of that leaf's largest, every
    updated parameter within ``SHARD_PARAM_ATOL`` (times |p| where |p|
    > 1: a few float32 ulps at any size) wherever |m| is at
    least twice that limit and |g| at least ``SHARD_G_FLOOR`` (there g
    has one sign on both sides and Adam's first step, lr g / (|g| +
    eps), is the same to float32 rounding), within 2 lr elsewhere (the
    step is sign-like where g is rounding noise). Given ``rounding`` (the
    single-device float32 step's first moments from the same state and
    batch, on the host), a leaf's limit is at least ``SHARD_ROUND_K``
    times the largest |m - rounding| of that leaf: how far bf16 rounding
    alone moves the single-device step there. Returns the numbers (the
    five largest shares of a leaf's limit under ``worst``, the largest of
    ``rtol``'s alone under ``grad_share_of_rtol``), the sharded state and
    the kernels' launches in the sharded step."""
    import torch
    from repro_torch import sharding
    from repro_torch.kernels import lru_scan as klru
    from repro_torch.kernels import wkv6 as kw6
    from repro_torch.launch import specs
    from repro_torch.training import init_state, make_train_step
    from repro_torch.training.tree import leaves

    ocfg = train_ocfg(1)
    one = init_state(cfg, ocfg, 0, device="cuda")
    if prepare is not None:
        prepare(one)
    two = specs.place_state(one, ctx)
    _, m1 = make_train_step(cfg, ocfg)(
        one, {k: v.clone() for k, v in batch.items()})
    with sharding.use(ctx):
        step = make_train_step(cfg, ocfg)
    kw6.reset_launch_counts()
    klru.reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    two, m2 = step(two, batch)
    torch.cuda.synchronize()
    first_ms = 1e3 * (time.perf_counter() - t0)
    launches = {**kw6.LAUNCHES, **klru.LAUNCHES}
    l1, l2 = float(m1["loss"]), float(m2["loss"])
    lim = loss_atol if loss_atol is not None else 1e-4 * abs(l1)
    if not abs(l1 - l2) <= lim:
        raise AssertionError(f"{tag} sharded loss {l2} against the single "
                             f"device's {l1} (limit {lim:.1e})")
    share, plain, pmax, ptight, held, shares = 0.0, 0.0, 0.0, 0.0, 0, []
    floor = (1 - ocfg.b1) * SHARD_G_FLOOR
    top = max(float(b.abs().max()) for b in leaves(one["opt"]["m"]))
    pairs = zip(leaves(two["opt"]["m"]), leaves(one["opt"]["m"]),
                leaves(two["params"]), leaves(one["params"]))
    for i, (a, b, pa, pb) in enumerate(pairs):
        a = sharding.gather_tensor(a)
        glim = leaf_limit(rtol, b, top)
        err = float((a - b).abs().max())
        plain = max(plain, err / glim)
        if rounding is not None:
            glim = max(glim, SHARD_ROUND_K * float(
                (b - rounding[i].to(b.device)).abs().max()))
        shares.append((err / glim, i, tuple(b.shape)))
        if not err <= glim:
            raise AssertionError(
                f"{tag} gradient leaf {i} {tuple(b.shape)} off by "
                f"{err:.3e} (limit {glim:.3e}); the largest shares so far "
                f"(share, leaf, shape): {sorted(shares, reverse=True)[:8]}")
        share = max(share, err / glim)
        d = (sharding.gather_tensor(pa) - pb).abs()
        sure = (b.abs() >= 2 * glim) & (b.abs() >= floor)
        pmax = max(pmax, float(d.max()))
        ptight = max(ptight, float(torch.where(
            sure, d / pb.abs().clamp_min(1.0), 0).max()))
        held += int(sure.sum())
    if not pmax <= 2 * m1["lr"] * 1.001 or not ptight <= SHARD_PARAM_ATOL:
        raise AssertionError(
            f"{tag} an updated parameter {pmax:.3e} off (limit 2 lr = "
            f"{2 * m1['lr']:.1e}), {ptight:.3e} where the gradient's sign "
            f"is sure (limit {SHARD_PARAM_ATOL:.0e})")
    del one
    free_device_memory()
    return {"loss_single": l1, "loss_sharded": l2, "grad_share": share,
            "grad_share_of_rtol": plain,
            "worst": [[s, i, list(shape)] for s, i, shape
                      in sorted(shares, reverse=True)[:5]],
            "param_max_diff": pmax, "param_sure_diff": ptight,
            "param_sure_count": held, "first_step_ms": first_ms,
            "leaves": len(leaves(two["params"]))}, two, launches


def shard_f32_check(tag, cfg, ctx, hook=("transformer", "sum_heads"),
                    batch=TRAIN_BATCH, seq=SHARD_F32_SEQ, prepare=None,
                    keep_state=False):
    """A float32 copy (TF32 off) of the first ``SHARD_F32_LAYERS`` layers
    at B ``batch``, S ``seq`` (its state made by ``prepare``, as
    :func:`shard_step_pair` takes it): the sharded step against the
    single-device step at ``GRAD_RTOL``, the losses within 1e-4
    relative; the same check must fail a sharded step that drops
    ``hook`` (a module of ``repro_torch.models`` and its sum or exchange
    over the model axis: by default the sum after ``wo``). Returns the
    numbers and, with ``keep_state``, the sharded state (for [17c]; else
    it is freed before the mutant's step)."""
    import dataclasses
    import importlib

    from repro_torch.training import SyntheticLM

    cfg2 = dataclasses.replace(cfg, n_layers=SHARD_F32_LAYERS,
                               compute_dtype="float32")
    data = SyntheticLM(cfg2, batch, seq, seed=1, device="cuda").next()
    out, state, _ = shard_step_pair(tag, cfg2, ctx, data, prepare)
    if not keep_state:
        state = None
        free_device_memory()
    module = importlib.import_module(f"repro_torch.models.{hook[0]}")
    saved = getattr(module, hook[1])
    setattr(module, hook[1], lambda parts: parts)
    try:
        shard_step_pair(tag, cfg2, ctx, data, prepare)
    except AssertionError as e:
        out["dropped_" + hook[1]] = str(e)
    else:
        raise AssertionError(f"{tag} the float32 check does not catch a "
                             f"sharded step that drops {hook[1]}")
    finally:
        setattr(module, hook[1], saved)
    log(f"{tag} {cfg.name} float32 copy ({SHARD_F32_LAYERS} layers, B "
        f"{batch}, S {seq}, TF32 off) sharded on {SHARD_MESH} == one "
        f"device: {out['leaves']} leaves (max {out['grad_share']:.3f} of "
        f"the limit {GRAD_RTOL} x the leaf's largest; params within "
        f"{out['param_sure_diff']:.2e} at {out['param_sure_count']:,} sure "
        f"elements), loss "
        f"{out['loss_sharded']:.6f} / {out['loss_single']:.6f}; dropping "
        f"{'.'.join(hook)} over the model axis fails it")
    return out, state


def shard_tinyllama(tag, reps):
    """[17a]: tinyllama-1.1b at full width on ``SHARD_LAYERS`` of its 22
    layers (cut for the script's time) on a (data 2, model
    2) mesh of ``cuda:0``: one bf16 step against the single-device step
    from the same state and batch (loss within ``SHARD_LOSS_ATOL``, every
    gradient leaf within ``SHARD_GRAD_RTOL`` of its largest, params as
    :func:`shard_step_pair` says), then ``SHARD_STEPS`` timed steps,
    their peak memory,
    and one step under ``torch.profiler``; the float32 check and its
    mutant."""
    from repro_torch.configs import get_config
    from repro_torch.training import SyntheticLM

    import dataclasses

    free_device_memory()
    cfg = dataclasses.replace(get_config(TRAIN_ARCH), n_layers=SHARD_LAYERS)
    ctx = shard_ctx(SHARD_MESH)
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device="cuda")
    out, state = shard_full_pair(tag, cfg, ctx, data)
    out.update(shard_timed(tag, cfg, ctx, data, state, SHARD_STEPS,
                           ("copy", "elementwise")))
    del state
    free_device_memory()
    out["f32"], f32_state = shard_f32_check(tag, cfg, ctx, keep_state=True)
    return out, f32_state


def shard_full_pair(tag, cfg, ctx, data):
    """:func:`shard_step_pair` in bf16 at ``[17a]``'s limits on the next
    batch of ``data``, logged; returns its numbers and the sharded
    state."""
    out, state, _ = shard_step_pair(tag, cfg, ctx, data.next(),
                                    rtol=SHARD_GRAD_RTOL,
                                    loss_atol=SHARD_LOSS_ATOL)
    log(f"{tag} {cfg.name} ({cfg.n_layers} layers, d {cfg.d_model}) at B "
        f"{data.batch}, S {data.seq} on a {SHARD_MESH} (data, model) mesh "
        f"of cuda:0: loss "
        f"{out['loss_sharded']:.5f} against one device's "
        f"{out['loss_single']:.5f} (limit {SHARD_LOSS_ATOL}); "
        f"{out['leaves']} gradient leaves within {out['grad_share']:.3f} of "
        f"the limit {SHARD_GRAD_RTOL} x the leaf's largest; params within "
        f"{out['param_max_diff']:.2e}, and within "
        f"{out['param_sure_diff']:.2e} at the {out['param_sure_count']:,} "
        f"elements whose gradient's sign is sure (limit {SHARD_PARAM_ATOL}); "
        f"first step {out['first_step_ms']:.0f} ms")
    return out, state


def shard_timed(tag, cfg, ctx, data, state, steps, kernel):
    """``steps`` sharded steps from ``state`` on ``data``'s batches, each
    timed on the host clock around a synchronised step, their peak
    memory, then one more under ``torch.profiler`` (``kernel`` as
    :func:`device_breakdown` takes it). The state is updated in place."""
    import statistics

    import torch
    from repro_torch import sharding
    from repro_torch.training import make_train_step

    with sharding.use(ctx):
        step = make_train_step(cfg, train_ocfg(1 + steps))
    torch.cuda.reset_peak_memory_stats()
    ms = []
    for _ in range(steps):
        b = data.next()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        if not math.isfinite(float(m["loss"])):
            raise AssertionError(f"{tag} non-finite loss {float(m['loss'])}")
    out = {"step_ms": ms, "steady_step_ms": statistics.median(ms),
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    out["tokens_per_s"] = data.batch * data.seq / (out["steady_step_ms"]
                                                    / 1e3)
    b = data.next()
    held = {}

    def one():
        held["state"], _ = step(state, b)

    out["profile"] = device_breakdown(one, kernel)
    del held
    log(f"{tag} {steps} sharded steps: "
        + ", ".join(f"{x:.1f}" for x in ms)
        + f" ms (median {out['steady_step_ms']:.1f}, "
        f"{out['tokens_per_s']:,.0f} tokens/s), peak {out['peak_gib']:.2f} "
        f"GiB; one more under torch.profiler: "
        + breakdown_line(out["profile"]))
    return out


def draw_wb_lora(state):
    """rwkv6-3b's ``wb_lora`` drawn non-zero in a stage-layout state
    (zero at init makes every decay constant), as [10] draws it."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(1)
    for w in state["params"]["stage0"]["b0"]["wb_lora"]:
        w.normal_(0.0, WB_LORA_STD, generator=g)


def single_f32_moments(cfg, batch, prepare=None):
    """The first moments (on the host) of one single-device float32 step
    (TF32 off) of ``cfg`` from :func:`shard_step_pair`'s state and
    ``batch``: the bf16 step's rounding floor."""
    import dataclasses

    from repro_torch.training import init_state, make_train_step
    from repro_torch.training.tree import leaves

    cfg32 = dataclasses.replace(cfg, compute_dtype="float32")
    ocfg = train_ocfg(1)
    state = init_state(cfg32, ocfg, 0, device="cuda")
    if prepare is not None:
        prepare(state)
    state, _ = make_train_step(cfg32, ocfg)(
        state, {k: v.clone() for k, v in batch.items()})
    out = [m.cpu() for m in leaves(state["opt"]["m"])]
    del state
    free_device_memory()
    return out


def shard_recurrent(tag, reps):
    """[17b]: rwkv6-3b and recurrentgemma-9b at full width, depth cut to
    ``SHARD_REC_LAYERS``, on a (data 2, model 2) mesh of ``cuda:0``: one
    bf16 step against the single-device step at [17a]'s limits, each
    gradient leaf's at least ``SHARD_ROUND_K`` times how far the
    single-device float32 step's is from the bf16 one's
    (:func:`single_f32_moments`), the
    recurrence kernels' launches on the 4 shards (forward and recompute
    on each shard, one backward), ``SHARD_STEPS`` timed steps and one
    profiled (:func:`shard_timed`); each arch's kernel and its backward
    at a model shard's shapes (:func:`shard_kernels`); the float32
    2-layer copy and its mutant without the sum after ``w_out_t`` or
    ``w_out_rec`` (:func:`shard_f32_check`)."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.training import SyntheticLM

    out, launches, kernels = {}, {}, {}
    ctx = shard_ctx(SHARD_MESH)
    shards = math.prod(SHARD_MESH)
    for arch, kernel in ((RWKV_ARCH, "wkv6"), (RG_ARCH, "lru_scan")):
        free_device_memory()
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=SHARD_REC_LAYERS)
        prepare = draw_wb_lora if arch == RWKV_ARCH else None
        data = SyntheticLM(cfg, RWKV_TRAIN_BATCH, TRAIN_SEQ, seed=0,
                           device="cuda")
        batch = data.next()
        rounding = single_f32_moments(cfg, batch, prepare)
        rec, state, got = shard_step_pair(
            tag, cfg, ctx, batch, prepare, rtol=SHARD_GRAD_RTOL,
            loss_atol=SHARD_LOSS_ATOL, rounding=rounding)
        del rounding
        n = transformer.layer_kinds(cfg).count(
            "rwkv" if kernel == "wkv6" else "rec")
        want = {kernel: 2 * n * shards, kernel + "_bwd": n * shards}
        got = {k: got[k] for k in want}
        if got != want:
            raise AssertionError(f"{tag} {arch} launches {got}, expected "
                                 f"{want} ({shards} shards: forward, "
                                 "recompute and backward a layer each)")
        rec["launches"] = got
        launches.update(got)
        log(f"{tag} {arch} ({SHARD_REC_LAYERS} layers) at B "
            f"{RWKV_TRAIN_BATCH}, S {TRAIN_SEQ} on {SHARD_MESH} (data, "
            f"model): loss {rec['loss_sharded']:.5f} / "
            f"{rec['loss_single']:.5f} (limit {SHARD_LOSS_ATOL}), "
            f"{rec['leaves']} gradient leaves within "
            f"{rec['grad_share']:.3f} of the limit (the larger of "
            f"{SHARD_GRAD_RTOL} x the leaf's largest and {SHARD_ROUND_K} x "
            f"its bf16 rounding; largest shares, leaf, shape: "
            f"{rec['worst']}; of the first alone "
            f"{rec['grad_share_of_rtol']:.3f}), params within "
            f"{rec['param_sure_diff']:.2e} at {rec['param_sure_count']:,} "
            f"sure elements; launches {got}; first step "
            f"{rec['first_step_ms']:.0f} ms")
        rec.update(shard_timed(tag, cfg, ctx, data, state, SHARD_STEPS,
                               (kernel + "_bwd", kernel)))
        dev = (rec["profile"]["device_ms"] or {})
        rec["profile_ms_a_launch"] = {
            k: dev[k] / want[k] if k in dev else None for k in want}
        del state
        free_device_memory()
        rec["kernels"] = shard_kernels(tag, cfg, kernel, reps)
        kernels.update(rec["kernels"])
        free_device_memory()
        rec["f32"], _ = shard_f32_check(
            tag, cfg, ctx, ("transformer", SHARD_REC_HOOKS[arch]),
            prepare=prepare)
        out[arch] = rec
    free_device_memory()
    return out, launches, kernels


def shard_kernels(tag, cfg, kernel, reps):
    """[17b]: ``kernel`` (``wkv6`` or ``lru_scan``) and its backward at
    the shapes one model shard of a (data 2, model 2) step gives them (B
    ``RWKV_TRAIN_BATCH`` / 2; ``wkv6`` on the shard's half of the heads,
    ``lru_scan`` on its half of the channels), on [2c] / [2d]'s random
    inputs, against their plain versions at [2c]'s, [2d]'s, [16c]'s and
    [16d]'s limits, each limit held against its mutants; each timed
    beside its plain version and its bound."""
    import torch
    from repro_torch.kernels import lru_scan as klru
    from repro_torch.kernels import wkv6 as kw6

    dp, tp = SHARD_MESH
    b = RWKV_TRAIN_BATCH // dp
    gen = torch.Generator(device="cuda").manual_seed(172)
    if kernel == "wkv6":
        shape = (b * cfg.d_model // 64 // tp, TRAIN_SEQ, 64, 64)
        args = wkv_case(*shape, seed=171)
        fwd_err = wkv_check(kw6, args, tag)
        fwd = kernel_timing(lambda: kw6.wkv6(*args),
                            lambda: kw6.wkv6_plain(*args),
                            *wkv_bound(args), reps)
        dy = torch.randn(args[3].shape, device="cuda", generator=gen)
        bwd_err = wkv_bwd_check(kw6, args, dy, tag)
        bwd = kernel_timing(lambda: kw6.wkv6_backward(*args, dy),
                            lambda: kw6.wkv6_backward_plain(*args, dy),
                            *wkv_bwd_bound(args), reps)
        del args, dy
    else:
        shape = (b, TRAIN_SEQ, (cfg.lru_width or cfg.d_model) // tp)
        a, x = lru_case(*shape, seed=173, dtype=torch.float32)
        fwd_err = lru_check(klru, a, x, tag)
        fwd = kernel_timing(lambda: klru.lru_scan(a, x),
                            lambda: klru.lru_scan_plain(a, x),
                            *klru.lru_scan_cost(*a.shape), reps)
        with torch.no_grad():
            h = klru.lru_scan(a, x)
        dh = torch.randn(a.shape, device="cuda", generator=gen)
        bwd_err = lru_bwd_check(klru, a, h, dh, tag)
        bwd = kernel_timing(lambda: klru.lru_scan_backward(a, h, dh),
                            lambda: klru.lru_scan_backward_plain(a, h, dh),
                            *klru.lru_scan_bwd_cost(*a.shape), reps)
        del a, x, h, dh
    out = {}
    for name, rec, (err, share) in ((kernel, fwd, fwd_err),
                                    (kernel + "_bwd", bwd, bwd_err)):
        rec.update(max_abs_err=err, limit_share=share, shape=list(shape))
        out[name] = rec
        log(f"{tag} {name} at a model shard's {shape} == plain (max err "
            f"{err:.3e}, {share:.3f} of the limit; its mutants fail it): "
            f"{rec['ms']:.3f} ms a launch (plain {rec['plain_ms']:.1f}, "
            f"bound {rec['bound_ms']:.4f} by {rec['bound_by']})")
    return out


def shard_reshard(tag, state):
    """[17c]: [17a]'s float32 sharded state saved on (2, 2) and restored
    onto (2, 1) (reshard on load), bitwise; save and load timed."""
    import os
    import tempfile

    import torch
    from repro_torch import sharding
    from repro_torch.launch import specs
    from repro_torch.training import CheckpointManager
    from repro_torch.training.tree import leaves

    ctx2 = shard_ctx((2, 1))
    with tempfile.TemporaryDirectory() as tmp:
        mgr = CheckpointManager(os.path.join(tmp, "ck"), async_save=False)
        t0 = time.perf_counter()
        mgr.save(state, {"step": 1})
        save_ms = 1e3 * (time.perf_counter() - t0)
        with sharding.use(ctx2):
            t0 = time.perf_counter()
            back, _ = mgr.restore_latest(
                like=state, shardings=specs.state_shardings(state, ctx2))
            torch.cuda.synchronize()
            load_ms = 1e3 * (time.perf_counter() - t0)
    placed = [x for x in leaves(back) if isinstance(x, sharding.Sharded)]
    if not placed or any(x.mesh is not ctx2.mesh for x in placed):
        raise AssertionError(f"{tag} the restore is not on the (2, 1) mesh")
    for a, b in zip(leaves(back), leaves(state)):
        if isinstance(a, sharding.Sharded):
            a, b = sharding.gather_tensor(a), sharding.gather_tensor(b)
        if not torch.equal(a, b):
            raise AssertionError(f"{tag} a leaf did not reshard bitwise")
    log(f"{tag} saved on {SHARD_MESH}, restored on (2, 1): {len(placed)} "
        f"sharded leaves bitwise; save {save_ms:.0f} ms, load {load_ms:.0f}"
        " ms")
    return {"save_ms": save_ms, "load_ms": load_ms}


def shard_cp_als(tag):
    """[17d]: ``cp_als(mesh=ctx)`` (a (data 2, model 2) context; ALS uses
    its data axis only) at nell1 ``DIST_SCALE`` against ``cp_als(mesh=)``
    on the (data 2) mesh it implies: fits within ``FIT_ATOL`` (the card
    is not run-to-run bitwise), the row 4 kernel launched on the shards."""
    import torch
    from repro_torch.core import (build_sharded_flycoo, cp_als,
                                  init_factors, spec, synthesize)
    from repro_torch.engine import ExecutionConfig
    from repro_torch.kernels import mttkrp as kmt

    ts = spec("nell1", scale=DIST_SCALE)
    indices, values = synthesize(ts, seed=0)
    t = build_sharded_flycoo(indices, values, ts.dims, n_dev=4)
    cfg = ExecutionConfig(backend="cuda_fused", rank_hint=RANK)
    fits = {}
    for name, mesh in (("ctx", shard_ctx(SHARD_MESH)),
                       ("mesh", dist_mesh(2))):
        factors = init_factors(torch.Generator(device="cuda").manual_seed(0),
                               t.dims, RANK)
        kmt.reset_launch_counts()
        res = cp_als(t, RANK, iters=3, config=cfg, factors=factors,
                     mesh=mesh)
        torch.cuda.synchronize()
        if name == "ctx":
            launches = kmt.LAUNCHES["mttkrp_fused_gather_compact"]
        fits[name] = list(res.fits)
    gap = max(abs(a - b) for a, b in zip(fits["ctx"], fits["mesh"]))
    if not gap <= FIT_ATOL or not launches:
        raise AssertionError(f"{tag} cp_als(mesh=ctx) fits {fits['ctx']} "
                             f"against {fits['mesh']}; row 4 launches "
                             f"{launches}")
    log(f"{tag} cp_als(mesh=ctx) at nell1 {DIST_SCALE} on 2 data shards: "
        f"fits {fits['ctx'][-1]:.6f} within {gap:.1e} of cp_als(mesh=Mesh) "
        f"(limit {FIT_ATOL}); {launches} mttkrp_fused_gather_compact "
        "launches on the shards")
    return {"fits": fits, "fit_gap": gap,
            "launches": {"mttkrp_fused_gather_compact": launches}}


def shard_primitives(tag):
    """[17e]: ``pipeline_apply`` over 4 stages of ``cuda:0`` against the
    sequential stages (1e-5), and ``compressed_grad_sync`` over 4 pod
    positions of ``cuda:0``: every position equal, the error feedback
    the residual, a rank above the matrix's exact; both timed."""
    import torch
    from repro_torch.training.compression import compressed_grad_sync
    from repro_torch.training.pipeline import pipeline_apply

    g = torch.Generator(device="cuda").manual_seed(0)
    ws = torch.randn(4, PIPE_D, PIPE_D, device="cuda", generator=g) \
        / math.sqrt(PIPE_D)
    x = torch.randn(PIPE_BATCH, PIPE_D, device="cuda", generator=g)

    def stage_fn(w, h):
        return torch.tanh(h @ w)

    want = x
    for s in range(4):
        want = stage_fn(ws[s], want)
    mesh = dist_mesh(4, axes=("pp",))
    y = pipeline_apply(stage_fn, ws, x, mesh=mesh, n_micro=PIPE_MICRO)
    perr = float((y - want).abs().max())
    if not perr <= 1e-5:
        raise AssertionError(f"{tag} pipeline_apply off by {perr:.2e}")
    pipe_ms = cuda_ms(lambda: pipeline_apply(stage_fn, ws, x, mesh=mesh,
                                             n_micro=PIPE_MICRO), 3)
    grads = [{"w": torch.randn(COMPRESS_SHAPE, device="cuda", generator=g),
              "b": torch.randn(64, device="cuda", generator=g)}
             for _ in range(4)]
    gen = torch.Generator(device="cuda").manual_seed(1)
    synced, err = compressed_grad_sync(grads, COMPRESS_RANK, generator=gen)
    for k in range(4):
        if not torch.equal(synced[k]["w"], synced[0]["w"]):
            raise AssertionError(f"{tag} the pods disagree after the sync")
        res = float((err[k]["w"] - (grads[k]["w"] - synced[k]["w"]))
                    .abs().max())
        if res > 1e-5:
            raise AssertionError(f"{tag} the error feedback is not the "
                                 f"residual ({res:.2e})")
    mean_b = sum(gr["b"] for gr in grads) / 4
    if float((synced[0]["b"] - mean_b).abs().max()) > 1e-6:
        raise AssertionError(f"{tag} the small leaf is not the exact mean")
    small = [{"w": gr["w"][:, :16].contiguous()} for gr in grads]
    exact, _ = compressed_grad_sync(small, 16, generator=gen)
    mean_w = sum(s["w"] for s in small) / 4
    xerr = float((exact[0]["w"] - mean_w).abs().max())
    if xerr > 1e-4:
        raise AssertionError(f"{tag} a full-rank sync is {xerr:.2e} off the "
                             "mean")
    sync_ms = cuda_ms(lambda: compressed_grad_sync(grads, COMPRESS_RANK,
                                                   generator=gen), 3)
    log(f"{tag} pipeline_apply (4 stages, {PIPE_MICRO} microbatches, d "
        f"{PIPE_D}) within {perr:.1e} of the sequential stages, "
        f"{pipe_ms:.2f} ms; compressed_grad_sync (4 pods, "
        f"{COMPRESS_SHAPE} at rank {COMPRESS_RANK}) agrees on every pod, "
        f"error feedback = residual, full rank within {xerr:.1e} of the "
        f"mean, {sync_ms:.2f} ms")
    return {"pipeline_err": perr, "pipeline_ms": pipe_ms,
            "sync_ms": sync_ms, "full_rank_err": xerr}


def phase_shard(report, reps):
    """[17] Sharded training on the card (``sharding.py``, the sharded
    ``make_train_step``): [17a] tinyllama-1.1b at full width on (data 2,
    model 2), [17b] rwkv6-3b and recurrentgemma-9b on (data 2, model 2),
    [17c] the elastic restore, [17d] ``cp_als(mesh=ctx)``, [17e] the
    pipeline and the compressed sync. Returns the kernels' launches in
    the sharded paths and [17b]'s per-shard kernel records."""
    t0 = time.perf_counter()
    out = {}
    out["tinyllama"], f32_state = shard_tinyllama("[17a]", reps)
    out["recurrent"], launches, kernels = shard_recurrent("[17b]", reps)
    out["reshard"] = shard_reshard("[17c]", f32_state)
    del f32_state
    free_device_memory()
    out["cp_als"] = shard_cp_als("[17d]")
    launches.update(out["cp_als"]["launches"])
    out["primitives"] = shard_primitives("[17e]")
    report["shard"] = out
    free_device_memory()
    log(f"[17] passed in {time.perf_counter() - t0:.1f} s")
    return launches, kernels


# --------------------------------------------------------------------------
# [18] The MoE family.
# --------------------------------------------------------------------------
MOE_ARCH, MOE_BIG = "olmoe-1b-7b", "qwen3-moe-235b-a22b"
MOE_BIG_LAYERS = 4                     # [18b]: 94 layers would not fit one card
MOE_XCHECK_BATCH, MOE_XCHECK_SEQ = 2, 16
MOE_TRAIN_LAYERS, MOE_TRAIN_STEPS = 4, 3
MOE_GRAD_LAYERS, MOE_GRAD_SEQ = 2, 64  # [18c]'s float32 card-vs-CPU step
MOE_SHARD_LAYERS, MOE_SHARD_STEPS = 2, 2
MOE_F32_BATCH, MOE_F32_SEQ = 2, 32     # [18d]'s float32 copy
#: The profile's classes on the MoE path: the softmaxes (attention's and
#: the router's), and routing, dispatch and combine (the top-k and
#: dispatch sorts, the row gathers, ``index_copy`` / ``index_add``,
#: ``searchsorted``; the embedding's row gather and the loss's target
#: gather land there too).
MOE_KERNELS = {"softmax": ("softmax",),
               "dispatch_combine": ("sort", "index", "searchsorted",
                                    "scatter", "gather")}


def no_drops(cfg):
    """``cfg`` at a capacity factor of E / k: C is then the token count,
    so no expert drops a pair at any batch or split."""
    import dataclasses

    return dataclasses.replace(cfg,
                               capacity_factor=cfg.n_experts / cfg.top_k)


def expert_cast(model, cfg, reps):
    """CUDA-event ms (median of ``reps``) of casting every layer's expert
    weights to the compute dtype, one leaf at a time, as each decode
    step does (``moe._expert_ffn`` casts at use, as the reference's
    einsums do), and the bytes that moves (f32 read, bf16 written)."""
    import torch

    ws = [getattr(layer.moe, k) for layer in model.layers
          for k in ("w_gate", "w_up", "w_down")]

    def cast():
        for w in ws:
            w.to(cfg.cdtype)

    ms = cuda_median_ms(cast, reps)
    nbytes = sum(w.numel() for w in ws) * (
        4 + torch.finfo(cfg.cdtype).bits // 8)
    return ms, nbytes


def moe_run(tag, cfg, reps, g):
    """[18a]/[18b] for one MoE config: init on the card, the bf16 prefill
    (timed, profiled, peak), the float32 cross-check on a 4-layer copy
    over the same tensors at :func:`no_drops` (decode routes B tokens a
    step, the prefill B S: only without drops do the two agree), serving,
    and the decode step's expert casts. Returns the numbers (the model
    is freed)."""
    import dataclasses

    import torch
    from repro_torch.models import moe, transformer

    free_device_memory()
    t0 = time.perf_counter()
    model = transformer.init_model(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    gib = sum(p.numel() * p.element_size()
              for p in model.parameters()) / 2**30
    t_tok = DENSE_BATCH * DENSE_SEQ
    cap = moe._capacity(t_tok, cfg.top_k, cfg.n_experts,
                        cfg.capacity_factor)
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers, d {cfg.d_model}, "
        f"{cfg.n_heads} heads of {cfg.hd} / {cfg.n_kv_heads} KV, qk_norm "
        f"{cfg.qk_norm}, {cfg.n_experts} experts of d_ff {cfg.d_ff}, top-"
        f"{cfg.top_k}, capacity factor {cfg.capacity_factor} (C {cap} at "
        f"{t_tok} tokens), vocab {cfg.vocab}; {n_params:,} params ({gib:.2f}"
        f" GiB f32; param_count() {cfg.param_count():,}) initialised in "
        f"{time.perf_counter() - t0:.1f} s")
    tokens = torch.randint(0, cfg.vocab, (DENSE_BATCH, DENSE_SEQ),
                           generator=g, device="cuda")
    out = {"params": n_params, "param_gib": gib, "layers": cfg.n_layers,
           "batch": DENSE_BATCH, "seq": DENSE_SEQ, "capacity": cap,
           **dense_prefill(tag, model, cfg, tokens, reps, MOE_KERNELS)}
    with torch.no_grad():
        first = transformer.forward(model, cfg, tokens, return_hidden=True)
        same = torch.equal(first, transformer.forward(
            model, cfg, tokens, return_hidden=True))
    del tokens, first
    if not same:
        raise AssertionError(f"{tag} two bf16 prefills of the same tokens "
                             "give different hidden states")
    out["prefill_repeats_bitwise"] = True
    log(f"{tag} a second bf16 prefill of the same tokens: the final hidden "
        f"state bitwise the first's")
    cfg4 = no_drops(dataclasses.replace(cfg, n_layers=4,
                                        compute_dtype="float32"))
    prompt = torch.randint(0, cfg.vocab, (MOE_XCHECK_BATCH, MOE_XCHECK_SEQ),
                           generator=g, device="cuda")
    with torch.no_grad():
        xerr, xlogit = xcheck(tag, first_layers(model, cfg4), cfg4, prompt)
    out["xcheck_max_abs_diff"] = xerr
    out["xcheck_max_abs_logit"] = xlogit
    out.update(serve_check(tag, model, cfg, DENSE_BATCH, g,
                           {**MOE_KERNELS, "copy": ("copy",)}))
    ms, nbytes = expert_cast(model, cfg, reps)
    step = out["serve"][1]["ms_per_step"]
    out["decode_expert_cast"] = {"ms": ms, "bytes": nbytes,
                                 "bound_ms": 1e3 * nbytes / HBM_BYTES_PER_S,
                                 "share_of_step": ms / step}
    log(f"{tag} a decode step's casts of the expert weights to "
        f"{cfg.compute_dtype}: {ms:.2f} ms on the card (median of {reps}; "
        f"{nbytes / 1e9:.1f} GB, bound {1e3 * nbytes / HBM_BYTES_PER_S:.2f}"
        f" ms at 3.35 TB/s), {ms / step:.1%} of a warm decode step's "
        f"{step:.2f} ms")
    del model
    free_device_memory()
    return out


def moe_train(tag):
    """[18c]: olmoe-1b-7b at full width on ``MOE_TRAIN_LAYERS`` layers
    (at 16 its AdamW state alone takes 111 GB), B 4, S 4096, AdamW,
    ``MOE_TRAIN_STEPS`` timed steps and one profiled, then a float32
    copy of ``MOE_GRAD_LAYERS`` layers stepped on the card and on the
    CPU from the same state (default capacity: both drop the same
    pairs)."""
    import dataclasses

    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=MOE_TRAIN_LAYERS)
    state, out = train_run(tag, cfg, TRAIN_BATCH, TRAIN_SEQ,
                           MOE_TRAIN_STEPS, profile=MOE_KERNELS)
    out.update(train_grad_check(tag, cfg, state, MOE_GRAD_LAYERS,
                                MOE_GRAD_SEQ))
    del state
    free_device_memory()
    return out


def moe_shard(tag):
    """[18d]: olmoe-1b-7b at full width on ``MOE_SHARD_LAYERS`` layers,
    its 64 experts over the model axis of a (data 2, model 2) mesh of
    ``cuda:0`` (32 a shard). The checks run at :func:`no_drops` (a model
    shard routes its own slice of the tokens with that slice's capacity:
    only without drops is the single-device step the same function): one
    bf16 step against the single-device step at [17a]'s limits, and the
    float32 copy and the copy without the exchange that returns the
    experts' outputs, which must fail. The timed steps, their peak and
    the profiled step run from that step's state at the config's own
    capacity factor (1.25), the traffic users train at."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.training import SyntheticLM

    free_device_memory()
    cfg = dataclasses.replace(get_config(MOE_ARCH),
                              n_layers=MOE_SHARD_LAYERS)
    ctx = shard_ctx(SHARD_MESH)
    data = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=0, device="cuda")
    out, state = shard_full_pair(tag, no_drops(cfg), ctx, data)
    log(f"{tag} the timed and profiled steps at capacity factor "
        f"{cfg.capacity_factor} (the check above at "
        f"{no_drops(cfg).capacity_factor:g})")
    out["timed_capacity_factor"] = cfg.capacity_factor
    out.update(shard_timed(tag, cfg, ctx, data, state, MOE_SHARD_STEPS,
                           {**MOE_KERNELS, "copy": ("copy",)}))
    del state
    free_device_memory()
    out["f32"], _ = shard_f32_check(tag, no_drops(cfg), ctx,
                                    ("moe", "from_experts"), MOE_F32_BATCH,
                                    MOE_F32_SEQ)
    free_device_memory()
    return out


def phase_moe(report, reps):
    """[18] The MoE family (no port kernel on this path: routing,
    dispatch, combine and the experts' batched products are PyTorch ops,
    as the reference's are ``jnp`` ops): olmoe-1b-7b at full width and
    depth ([18a]), qwen3-moe-235b-a22b at full width on
    ``MOE_BIG_LAYERS`` layers ([18b]: ~9.95 GB of f32 a layer, 45 GB at
    4, its 94 would not fit one card), olmoe training on 4 layers
    ([18c]) and sharded on 2 ([18d])."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(18)
    out = {MOE_ARCH: moe_run("[18a]", get_config(MOE_ARCH), reps, g)}
    out[MOE_BIG] = moe_run("[18b]", dataclasses.replace(
        get_config(MOE_BIG), n_layers=MOE_BIG_LAYERS), reps, g)
    out["train"] = moe_train("[18c]")
    out["shard"] = moe_shard("[18d]")
    report["moe"] = out
    log(f"[18] passed in {time.perf_counter() - t0:.1f} s")


# --------------------------------------------------------------------------
# [19] The other families: command-r's parallel block, paligemma's
# prefix-LM, whisper's encoder-decoder, and the int8 KV cache.
# --------------------------------------------------------------------------
CMDR_ARCH, PALI_ARCH, WHISPER_ARCH = ("command-r-plus-104b", "paligemma-3b",
                                      "whisper-large-v3")
CMDR_LAYERS = 4                        # [19a]: 37.8 GB of f32 at 4 of 64
LM_REPS = 1                            # [15], [18], [19]: timed prefills
WHISPER_TRAIN_LAYERS = 8               # [19e]: decoder and encoder depth
WHISPER_FRAMES = 1536                  # [19c]'s serving frames
KVQ_STEPS = 32                         # [19d]: teacher-forced decode steps
KVQ_DRAWS = 4                          # [19d]: half-step perturbations a step
KVQ_RATIO = 2.0                        # [19d]: the limit, x the draws' size
CMDR_TRAIN_LAYERS = 1                  # [19e]: Adafactor, B 1
FAMILY_TRAIN_STEPS = 2
FAMILY_GRAD_SEQ = 128                  # [19e]'s float32 card-vs-CPU steps
PALI_GRAD_SEQ = 320                    # 256 image tokens + 64 text
#: [19e]'s command-r checks (the card-vs-CPU step and the sharded pair)
#: at a width that fits them: the attention's 128-wide heads in groups
#: of 12 a KV head, d_ff / d 2.75, the parallel block, LayerNorm and the
#: tied head kept; d 12288 -> 3072, 96 / 8 heads -> 24 / 2, d_ff 33792
#: -> 8448, vocab 256000 -> 32000.
CMDR_CUT = dict(d_model=3072, n_heads=24, n_kv_heads=2, d_ff=8448,
                vocab=32000)


def family_init(tag, cfg):
    """``init_model`` on the card from seed 0, logged with its size."""
    import torch
    from repro_torch.models import transformer

    free_device_memory()
    t0 = time.perf_counter()
    model = transformer.init_model(cfg, 0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    gib = sum(p.numel() * p.element_size()
              for p in model.parameters()) / 2**30
    log(f"{tag} {cfg.name}: {cfg.n_layers} layers"
        + (f" + {cfg.n_enc_layers} encoder layers" if cfg.n_enc_layers
           else "")
        + f", d {cfg.d_model}, {cfg.n_heads} heads of {cfg.hd} / "
        f"{cfg.n_kv_heads} KV, d_ff {cfg.d_ff} ({cfg.act}), vocab "
        f"{cfg.vocab}, norm {cfg.norm}, parallel block "
        f"{cfg.parallel_block}, kind {cfg.kind}; {n_params:,} params "
        f"({gib:.2f} GiB f32; param_count() {cfg.param_count():,}) "
        f"initialised in {time.perf_counter() - t0:.1f} s")
    return model, {"params": n_params, "param_gib": gib,
                   "layers": cfg.n_layers, "enc_layers": cfg.n_enc_layers}


def family_cmdr(tag, reps, g):
    """[19a]: command-r-plus-104b at full width on ``CMDR_LAYERS`` of its
    64 layers: the bf16 prefill at B 4, S 4096, the float32 check over
    the same 4 layers, serving; then [19d] on its tensors."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(CMDR_ARCH), n_layers=CMDR_LAYERS)
    model, out = family_init(tag, cfg)
    tokens = torch.randint(0, cfg.vocab, (DENSE_BATCH, DENSE_SEQ),
                           generator=g, device="cuda")
    out.update(batch=DENSE_BATCH, seq=DENSE_SEQ,
               **dense_prefill(tag, model, cfg, tokens, reps))
    del tokens
    cfg4 = dataclasses.replace(cfg, compute_dtype="float32")
    prompt = torch.randint(0, cfg.vocab, (DENSE_BATCH, DENSE_XCHECK_SEQ),
                           generator=g, device="cuda")
    with torch.no_grad():
        out["xcheck_max_abs_diff"], out["xcheck_max_abs_logit"] = xcheck(
            tag, first_layers(model, cfg4), cfg4, prompt)
    out.update(serve_check(tag, model, cfg, DENSE_BATCH, g, "softmax"))
    out["kv_quant"] = kv_quant_check("[19d]", model, cfg, g)
    del model
    free_device_memory()
    return out


def family_pali(tag, reps, g):
    """[19b]: paligemma-3b at full width and depth: the bf16 prefill of
    256 stub image embeddings and 3,840 text tokens (S 4096, B 4); the
    float32 check on a 4-layer copy without image tokens (the reference's
    ``vlm`` decodes causally and its engine takes no image embeddings,
    so only without a prefix are ``forward`` and ``Engine.prefill`` the
    same function); the prefix mask held separately; serving."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config

    cfg = get_config(PALI_ARCH)
    model, out = family_init(tag, cfg)
    n_img = cfg.n_img_tokens
    tokens = torch.randint(0, cfg.vocab, (DENSE_BATCH, DENSE_SEQ - n_img),
                           generator=g, device="cuda")
    embeds = torch.randn((DENSE_BATCH, n_img, cfg.d_model), generator=g,
                         device="cuda").to(cfg.cdtype)
    out.update(batch=DENSE_BATCH, seq=DENSE_SEQ, image_tokens=n_img,
               **dense_prefill(tag, model, cfg, tokens, reps,
                               embeds=embeds))
    del tokens, embeds
    cfg4 = dataclasses.replace(cfg, n_layers=4, n_img_tokens=0,
                               compute_dtype="float32")
    prompt = torch.randint(0, cfg.vocab, (DENSE_BATCH, DENSE_XCHECK_SEQ),
                           generator=g, device="cuda")
    with torch.no_grad():
        out["xcheck_max_abs_diff"], out["xcheck_max_abs_logit"] = xcheck(
            tag, first_layers(model, cfg4), cfg4, prompt)
        out["prefix"] = prefix_check(tag, model, cfg, g)
    out.update(serve_check(tag, model, cfg, DENSE_BATCH, g, "softmax"))
    del model
    free_device_memory()
    return out


def prefix_check(tag, model, cfg, g):
    """paligemma's prefix mask: a float32 2-layer copy's final hidden
    state of ``forward(tokens, embeds)`` (256 image + 64 text positions,
    B 1) on the card against the same on the CPU, max |diff| <=
    ``XCHECK_ATOL`` (values of ~1 after the final norm); a causal-mask
    variant on the card must miss it."""
    import dataclasses

    import torch
    from repro_torch.models import transformer
    from repro_torch.models.common import tree_of

    cfg2 = dataclasses.replace(cfg, n_layers=2, compute_dtype="float32")
    small = first_layers(model, cfg2)
    cpu = transformer.Model(cfg2, _tree_copy(tree_of(small), "cpu"))
    tok = torch.randint(0, cfg.vocab, (1, 64), generator=g, device="cuda")
    emb = torch.randn((1, cfg.n_img_tokens, cfg.d_model), generator=g,
                      device="cuda")
    got = transformer.forward(small, cfg2, tok, embeds=emb,
                              return_hidden=True)
    want = transformer.forward(cpu, cfg2, tok.cpu(), embeds=emb.cpu(),
                               return_hidden=True)
    err = float((got.cpu() - want).abs().max())
    if not err <= XCHECK_ATOL:
        raise AssertionError(f"{tag} prefix-mask forward on the card vs the "
                             f"CPU: max |diff| {err:.3e} > {XCHECK_ATOL}")
    keep = transformer._attn_mask_kind
    transformer._attn_mask_kind = lambda c, kind: ("causal", 0)
    try:
        bad = transformer.forward(small, cfg2, tok, embeds=emb,
                                  return_hidden=True)
    finally:
        transformer._attn_mask_kind = keep
    bad_err = float((bad.cpu() - want).abs().max())
    if not bad_err > XCHECK_ATOL:
        raise AssertionError(f"{tag} a causal-mask forward passes the prefix "
                             f"check ({bad_err:.3e})")
    log(f"{tag} prefix mask, f32, 2 layers, {cfg.n_img_tokens} image + 64 "
        f"text positions: the card's final hidden state == the CPU's (max "
        f"|diff| {err:.3e} <= {XCHECK_ATOL}); a causal mask misses it by "
        f"{bad_err:.3e}")
    return {"max_abs_diff": err, "causal_max_abs_diff": bad_err}


def family_whisper(tag, reps, g):
    """[19c]: whisper-large-v3 at full width and depth (32 encoder + 32
    decoder layers): the bf16 prefill at B 4, S 4096 with (B, S, D) stub
    frame embeddings (the reference's ``input_specs``), the float32 check
    on a 4 + 4-layer copy (``forward(tokens, enc_embeds)`` against
    ``Engine.prefill`` after ``build_cross_caches``), and serving with
    ``WHISPER_FRAMES`` encoder frames."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import layers

    cfg = get_config(WHISPER_ARCH)
    model, out = family_init(tag, cfg)
    tokens = torch.randint(0, cfg.vocab, (DENSE_BATCH, DENSE_SEQ),
                           generator=g, device="cuda")
    frames = torch.randn((DENSE_BATCH, DENSE_SEQ, cfg.d_model), generator=g,
                         device="cuda").to(cfg.cdtype)
    out.update(batch=DENSE_BATCH, seq=DENSE_SEQ, frames=DENSE_SEQ,
               **dense_prefill(tag, model, cfg, tokens, reps,
                               enc_embeds=frames))
    del tokens, frames
    cfg4 = dataclasses.replace(cfg, n_layers=4, n_enc_layers=4,
                               compute_dtype="float32")
    prompt = torch.randint(0, cfg.vocab, (DENSE_BATCH, DENSE_XCHECK_SEQ),
                           generator=g, device="cuda")
    enc4 = torch.randn((DENSE_BATCH, DENSE_XCHECK_SEQ, cfg.d_model),
                       generator=g, device="cuda")
    with torch.no_grad():
        out["xcheck_max_abs_diff"], out["xcheck_max_abs_logit"] = xcheck(
            tag, first_layers(model, cfg4), cfg4, prompt, enc4)
    try:
        layers.check_q_len(1500)
    except ValueError as e:
        log(f"{tag} whisper's real 1,500 encoder frames (30 s of audio) "
            f"are refused as the reference's chunk loop refuses them ({e}); "
            f"serving takes {WHISPER_FRAMES} = 3 x 512")
    else:
        raise AssertionError(f"{tag} 1,500 encoder frames were not refused")
    frames = torch.randn((DENSE_BATCH, WHISPER_FRAMES, cfg.d_model),
                         generator=g, device="cuda").to(cfg.cdtype)
    out.update(serve_check(tag, model, cfg, DENSE_BATCH, g, "softmax",
                           enc=frames))
    out["serve_frames"] = WHISPER_FRAMES
    del model, frames
    free_device_memory()
    return out


def kvq_draws(model, cfg, x0, c, pos, g):
    """[19d]'s yardstick: the logits of a 1-layer parallel-block model at
    decode position ``pos`` (its step's embedding ``x0``) over its float
    cache ``c``, each cached key and value moved by a uniform draw within
    half a quantization step (the row's int8 scale s, computed from the
    float row as the int8 engine computes it: rounding to the nearest
    step moves an element by at most s / 2), ``KVQ_DRAWS`` times; and
    the same with no move (which must be the float engine's logits)."""
    import torch
    from repro_torch.models import layers, transformer
    from repro_torch.models.common import apply_norm

    layer = model.layers[0]
    n = pos + 1
    h = apply_norm(layer.ln, x0, cfg)
    mlp = layers.apply_mlp(layer.mlp, h, cfg)
    scales = {k: layers._quantize_rows(c[k][:, :n])[1] for k in ("k", "v")}

    def logits(move):
        kv = {k: c[k][:, :n] + (move * (2 * torch.rand(
            c[k][:, :n].shape, generator=g, device=x0.device) - 1)
            * scales[k] / 2 if move else 0) for k in ("k", "v")}
        a, _ = layers.attention_decode(
            layer.attn, h, {**kv, "len": pos, "kv_len": n}, cfg,
            use_rope=cfg.rope_theta > 0, cross=True)
        return transformer._logits(model, x0 + a + mlp, cfg)[:, 0]

    return logits(0), [logits(1) for _ in range(KVQ_DRAWS)]


def kv_quant_check(tag, model, cfg, g):
    """[19d] the int8 KV cache (``kv_quant``) on command-r's tensors: a
    float32 1-layer copy (its layer 0, the parallel block) serves the
    same ``KVQ_STEPS`` tokens through an int8 engine and a float one,
    teacher-forced a token at a time. At every step every int8 row and
    scale the engine writes equals ``_quantize_rows`` of the float
    engine's row (the same layer input: one layer), exactly or +-1 at a
    rounding tie; and the int8 engine's logits stay within the limit of
    the module docstring, ``KVQ_RATIO`` x the size of the logit changes
    that ``kvq_draws``' half-step moves of the float cache make. An
    engine whose rows are read back without their scales must miss that
    limit. Then bf16 serving at the 4 layers with ``kv_quant``, and the
    cache bytes of both engines."""
    import dataclasses

    import torch
    from repro_torch.models import layers, transformer
    from repro_torch.serving import Engine, ServeConfig

    cfg1 = dataclasses.replace(cfg, n_layers=1, compute_dtype="float32")
    cfg1q = dataclasses.replace(cfg1, kv_quant=True)
    m1, m1q = first_layers(model, cfg1), first_layers(model, cfg1q)
    prompt = torch.randint(0, cfg.vocab, (DENSE_BATCH, KVQ_STEPS),
                           generator=g, device="cuda")
    v = cfg.vocab
    quantize = layers._quantize_rows

    def unscaled(x):
        q, s = quantize(x)
        return q, torch.ones_like(s)

    def run(drop_scales):
        eng = Engine(m1, cfg1, ServeConfig(DENSE_BATCH, KVQ_STEPS),
                     device="cuda")
        engq = Engine(m1q, cfg1q, ServeConfig(DENSE_BATCH, KVQ_STEPS),
                      device="cuda")
        draws = torch.Generator(device="cuda").manual_seed(191)
        worst, ties, rows = 0.0, 0, 0
        for t in range(KVQ_STEPS):
            tok = prompt[:, t:t + 1]
            lf = eng.prefill(tok)[:, 0, :v]
            if drop_scales:
                layers._quantize_rows = unscaled
            try:
                lq = engq.prefill(tok)[:, 0, :v]
            finally:
                layers._quantize_rows = quantize
            c, cq = eng.cache[0], engq.cache[0]
            for name in ("k", "v"):
                row = c[name][:, t:t + 1]
                want_q, want_s = quantize(row)
                got_q, got_s = cq[name][:, t:t + 1], cq[name + "_scale"][
                    :, t:t + 1]
                if not drop_scales and not torch.equal(got_s, want_s):
                    raise AssertionError(f"{tag} step {t}: {name}_scale "
                                         "differs from _quantize_rows'")
                off = (got_q.int() - want_q.int()).abs()
                frac = (row.float() / want_s).abs().frac()
                at_tie = (frac - 0.5).abs() <= 1e-5
                if (off > 1).any() or ((off == 1) & ~at_tie).any():
                    raise AssertionError(f"{tag} step {t}: an int8 {name} "
                                         "row differs from _quantize_rows' "
                                         "away from a rounding tie")
                ties += int((off == 1).sum())
                rows += row.numel()
            x0 = transformer.embed_lookup(m1, tok, cfg1)
            same, moved = kvq_draws(m1, cfg1, x0, c, t, draws)
            if not torch.allclose(same[:, :v], lf, rtol=0, atol=1e-5):
                raise AssertionError(f"{tag} step {t}: the yardstick's "
                                     "unmoved logits are not the float "
                                     "engine's")
            moves = torch.stack([m[:, :v] - lf for m in moved])
            diff = lq - lf
            share = max(
                float(diff.square().mean().sqrt()
                      / moves.square().mean().sqrt()),
                float(diff.abs().max() / moves.abs().max())) / KVQ_RATIO
            if not drop_scales and share > 1:
                raise AssertionError(
                    f"{tag} step {t}: int8 logits off by rms "
                    f"{float(diff.square().mean().sqrt()):.3e}, max "
                    f"{float(diff.abs().max()):.3e}: {share:.2f} x the "
                    "limit")
            worst = max(worst, share)
        return worst, ties, rows, float(diff.abs().max())

    with torch.no_grad():
        share, ties, rows, last = run(False)
        bad, _, _, _ = run(True)
    if not bad > 1:
        raise AssertionError(f"{tag} an engine that drops the scales stays "
                             f"within the limit ({bad:.2f} x)")
    log(f"{tag} kv_quant, f32 1-layer copy of {cfg.name}, B {DENSE_BATCH}, "
        f"{KVQ_STEPS} steps: every int8 row and scale == _quantize_rows of "
        f"the float engine's ({rows:,} elements, {ties} +-1 at a tie); "
        f"logits within {share:.3f} of the limit (last step max |diff| "
        f"{last:.3e}); rows read without their scales: {bad:.1f} x the "
        "limit")
    out = {"rows": rows, "ties": ties, "limit_share": share,
           "last_max_abs_diff": last, "dropped_scales_share": bad}
    cfgq = dataclasses.replace(cfg, kv_quant=True)
    out["serve"] = serve_check(tag, model, cfgq, DENSE_BATCH, g,
                               "softmax")["serve"]

    def cache_bytes(c):
        return sum(v.numel() * v.element_size() for layer_c in c
                   for v in layer_c.values() if isinstance(v, torch.Tensor))

    full = dataclasses.replace(cfg, n_layers=64)
    nb = {q: cache_bytes(transformer.init_cache(
        dataclasses.replace(full, kv_quant=q), 1, 4096, device="cuda"))
        for q in (False, True)}
    out.update(cache_bytes_bf16=nb[False], cache_bytes_int8=nb[True])
    log(f"{tag} the KV cache of one 4,096-token request at command-r's 64 "
        f"layers: {nb[True] / 2**30:.3f} GiB int8 + scales against "
        f"{nb[False] / 2**30:.3f} GiB bf16 ({nb[True] / nb[False]:.3f} x)")
    return out


def family_train(tag, reps, g):
    """[19e]: two training steps of each at a depth that fits one card
    (whisper on ``WHISPER_TRAIN_LAYERS`` + as many encoder layers, for
    time), each from seed 0 (``train_run``), then its float32 copy stepped on
    the card and on the CPU (``train_grad_check``), then the sharded
    pair: command-r at ``CMDR_CUT`` and paligemma at full width on 2
    layers over (data 2, model 2), with the copy that drops the sum
    after ``wo`` failing; whisper on 2 + 2 layers over (data 2, model
    2), with the copy that drops the sum after the cross-attention's
    ``wo`` failing."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.training import OptimizerConfig, init_state

    out = {}
    cmdr, pali, whisper = (get_config(a) for a in (CMDR_ARCH, PALI_ARCH,
                                                   WHISPER_ARCH))
    runs = (
        (CMDR_ARCH, dataclasses.replace(cmdr, n_layers=CMDR_TRAIN_LAYERS), 1,
         OptimizerConfig(name="adafactor", total_steps=FAMILY_TRAIN_STEPS,
                         warmup_steps=1)),
        (PALI_ARCH, pali, TRAIN_BATCH, None),
        (WHISPER_ARCH, dataclasses.replace(
            whisper, n_layers=WHISPER_TRAIN_LAYERS,
            n_enc_layers=WHISPER_TRAIN_LAYERS), TRAIN_BATCH, None))
    for arch, cfg, batch, ocfg in runs:
        state, out[arch] = train_run(tag, cfg, batch, TRAIN_SEQ,
                                     FAMILY_TRAIN_STEPS, ocfg=ocfg)
        if arch != CMDR_ARCH:
            out[arch]["grad"] = train_grad_check(
                tag, cfg, state, 2,
                PALI_GRAD_SEQ if arch == PALI_ARCH else FAMILY_GRAD_SEQ)
        del state
        free_device_memory()
    cut = dataclasses.replace(cmdr, n_layers=2, **CMDR_CUT)
    state = init_state(cut, train_ocfg(1), 0, device="cuda")
    out[CMDR_ARCH]["grad"] = train_grad_check(tag, cut, state, 2,
                                              FAMILY_GRAD_SEQ)
    del state
    free_device_memory()
    out["shard"] = {}
    for arch, cfg, seq in ((CMDR_ARCH, cut, FAMILY_GRAD_SEQ),
                           (PALI_ARCH, pali, PALI_GRAD_SEQ)):
        out["shard"][arch], _ = shard_f32_check(tag, cfg, shard_ctx(
            SHARD_MESH), batch=2, seq=seq)
        free_device_memory()
    out["shard"][WHISPER_ARCH], _ = shard_f32_check(
        tag, dataclasses.replace(whisper, n_enc_layers=SHARD_F32_LAYERS),
        shard_ctx(SHARD_MESH), ("transformer", "sum_xattn"), batch=2,
        seq=FAMILY_GRAD_SEQ)
    free_device_memory()
    return out


def phase_families(report, reps):
    """[19] The other families (no port kernel on this path):
    command-r-plus-104b ([19a]) with the int8 KV cache on its tensors
    ([19d]), paligemma-3b ([19b]), whisper-large-v3 ([19c]), and a
    training step of each, single-device and sharded ([19e])."""
    import torch

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(19)
    out = {}
    for tag, key, run in (("[19a], [19d]", CMDR_ARCH, family_cmdr),
                          ("[19b]", PALI_ARCH, family_pali),
                          ("[19c]", WHISPER_ARCH, family_whisper),
                          ("[19e]", "train", family_train)):
        t1 = time.perf_counter()
        out[key] = run(tag.split(",")[0], reps, g)
        log(f"{tag} took {time.perf_counter() - t1:.1f} s")
    out["seconds"] = time.perf_counter() - t0
    report["families"] = out
    log(f"[19] passed in {out['seconds']:.1f} s")


def kernels_record(per_kernel, launches, errs):
    """The ``kernels`` JSON line: ``per_kernel`` maps each kernel to its
    per-mode timing rows and a note of the tensor they were timed at."""
    out = []
    for kname, (rows, where) in per_kernel.items():
        per = [r[kname] for r in rows]
        bytes_ms = 1e3 * sum(p["bytes"] for p in per) / HBM_BYTES_PER_S
        ops_ms = 1e3 * sum(p["flops"] for p in per) / F32_FLOP_PER_S
        rec = {
            "name": kname, "route": "cuda", "source": SOURCES[kname],
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": errs[kname],
            "ms": sum(p["ms"] for p in per),
            "plain_ms": sum(p["plain_ms"] for p in per),
            "bound_ms": max(bytes_ms, ops_ms),
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None,
            "torch_backend_ms": sum(p["torch_backend_ms"] for p in per),
            "per": f"one rotation over the modes of {where}; library_ms "
                   "null: no single PyTorch call computes MTTKRP",
        }
        for key in ("gather_ms", "lidx_ms", "main_ms", "second_ms"):
            if key in per[0]:
                rec[key] = sum(p[key] for p in per)
        out.append(rec)
    return out


def dist_record(kernels, times, launches, err):
    """Add [14]'s numbers to each kernel's record: ``dist_launches``, its
    launches in [14]'s driven rotations ([14a]'s ``permute`` rotation,
    [14c]'s four; 0 for a kernel [14] does not run), and for the gather
    kernel [14a]'s per-shard sums over one rotation of 4 shards on one
    card."""
    shards = [x for m in times for x in m["shards"]]
    for rec in kernels:
        name = rec["name"]
        rec["dist_launches"] = launches.get(name, 0)
        if name != "mttkrp_fused_gather_compact":
            continue
        rec.update(
            dist_ms=sum(x["ms"] for x in shards),
            dist_plain_ms=sum(x["plain_ms"] for x in shards),
            dist_torch_backend_ms=sum(x["torch_backend_ms"] for x in shards),
            dist_bound_ms=1e3 * max(
                sum(x["bytes"] for x in shards) / HBM_BYTES_PER_S,
                sum(x["flops"] for x in shards) / F32_FLOP_PER_S),
            dist_max_abs_err=err,
            dist_per="one dist_all_modes rotation of nell1 (scale 0.1) "
                     "over 4 shards on one card: each shard's launch on its "
                     "own work table, summed")


# --------------------------------------------------------------------------
# [20] The dry-run's counts against the card.
# --------------------------------------------------------------------------
#: [20]'s calls: (tag of the phase that runs the call, arch, kind, B, S).
DRY_CALLS = (("[10]", RWKV_ARCH, "prefill", RWKV_BATCH, RWKV_SEQ),
             ("[15a]", "tinyllama-1.1b", "prefill", DENSE_BATCH, DENSE_SEQ),
             ("[16a]", TRAIN_ARCH, "train", TRAIN_BATCH, TRAIN_SEQ))
#: [20]'s limit on the predicted temporaries (peak less arguments) over
#: the bytes the call allocates on the card above what was allocated
#: before it: |ratio - 1| at most this (see the module docstring).
DRY_PEAK_RTOL = 0.02


def card_call(fn):
    """One real call of ``fn`` on the card: its CUDA-event ms, the bytes it
    allocates above what was allocated before it
    (``max_memory_allocated`` after ``reset_peak_memory_stats``, its
    result held until the peak is read), and, in a second call, the
    matmul FLOPs ``FlopCounterMode`` counts."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    rec = {"ms": start.elapsed_time(end), "base_bytes": base,
           "temp_bytes": torch.cuda.max_memory_allocated() - base}
    del out
    with FlopCounterMode(display=False) as fc:
        out = fn()
        torch.cuda.synchronize()
    del out
    rec["matmul_flops"] = fc.get_total_flops()
    return rec


def dry_call(arch, kind, batch, seq, device):
    """``(fn, argument bytes)`` of one of [20]'s calls on ``device``: a
    bf16 prefill ``forward`` of the arch's model (``rwkv_model``'s
    ``wb_lora`` draw on the card), or one ``make_train_step`` step of
    [16a]'s AdamW on ``init_state``, with [16a]'s batch."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.training import SyntheticLM, init_state, make_train_step
    from repro_torch.training.tree import leaves

    cfg = get_config(arch)
    if kind == "prefill":
        model = (rwkv_model(cfg, 0) if arch == RWKV_ARCH and device == "cuda"
                 else transformer.init_model(cfg, 0, device=device))
        tokens = torch.empty((batch, seq), dtype=torch.int64, device=device)
        if device != "meta":
            tokens.random_(0, cfg.vocab)
        args = list(model.parameters()) + [tokens]

        def fn():
            with torch.no_grad():
                return transformer.forward(model, cfg, tokens)
    else:
        ocfg = train_ocfg(TRAIN_STEPS)
        state = init_state(cfg, ocfg, 0, device=device)
        if device != "meta":
            b = SyntheticLM(cfg, batch, seq, seed=0, device=device).next()
        else:
            b = {k: torch.empty((batch, seq), dtype=torch.int32,
                                device=device)
                 for k in ("tokens", "targets")}
        step = make_train_step(cfg, ocfg)
        args = leaves(state["params"]) + leaves(state["opt"]["m"]) \
            + leaves(state["opt"]["v"]) + list(b.values())

        def fn():
            return step(state, b)
    return fn, sum(a.numel() * a.element_size() for a in args)


def meta_trace(arch, kind, batch, seq):
    """The same call traced on the ``meta`` device under
    ``analysis.cost.CostMode`` (one position): its counts and memory
    record."""
    from repro_torch.analysis.cost import CostMode

    with CostMode() as m:
        fn, _ = dry_call(arch, kind, batch, seq, "meta")
        m.mark_arguments()
        out = fn()
        mem = m.memory(out)
        del out
    return {"matmul_flops": m.matmul_flops, "flops": m.flops,
            "bytes": m.bytes, "kernels": m.kernels, "ops": m.ops,
            "allocated": m.allocated, **mem}


def phase_dryrun(report):
    """[20] The dry-run's counts (``analysis.cost``, the roofline of
    ``analysis.roofline``) against the card, on three calls the script
    runs: each traced on ``meta`` as a one-position cell and run on the
    card (:func:`card_call`). The matmul FLOPs must equal the card's
    ``FlopCounterMode`` count exactly; the predicted temporaries must be
    within ``DRY_PEAK_RTOL`` of what the call allocates, and a tracker
    that never frees must miss that; the roofline's largest term must not
    exceed the call's CUDA-event time."""
    import gc

    import torch
    from repro_torch.analysis.roofline import HW

    t0 = time.perf_counter()
    out = {}
    for tag, arch, kind, batch, seq in DRY_CALLS:
        free_device_memory()
        meta = meta_trace(arch, kind, batch, seq)
        fn, arg_bytes = dry_call(arch, kind, batch, seq, "cuda")
        fn()                                  # warm: workspaces, kernels
        card = card_call(fn)
        del fn
        gc.collect()
        name = f"{tag} {arch} {kind} (B {batch}, S {seq})"
        if meta["matmul_flops"] != card["matmul_flops"]:
            raise AssertionError(f"[20] {name}: meta matmul FLOPs "
                                 f"{meta['matmul_flops']:,} != the card's "
                                 f"{card['matmul_flops']:,}")
        pred = meta["peak"] - meta["argument"]
        ratio = pred / card["temp_bytes"]
        never = meta["allocated"] / card["temp_bytes"]
        if abs(ratio - 1) > DRY_PEAK_RTOL:
            raise AssertionError(f"[20] {name}: predicted temporaries "
                                 f"{pred / 2**30:.3f} GiB against "
                                 f"{card['temp_bytes'] / 2**30:.3f} GiB "
                                 f"allocated: ratio {ratio:.4f}")
        if abs(never - 1) <= DRY_PEAK_RTOL:
            raise AssertionError(f"[20] {name}: a tracker that never frees "
                                 f"({never:.4f}) passes the peak limit")
        terms = {"compute": meta["flops"] / HW["peak_flops"],
                 "memory": meta["bytes"] / HW["hbm_bw"]}
        by = max(terms, key=terms.get)
        bound_ms = 1e3 * terms[by]
        if bound_ms > card["ms"]:
            raise AssertionError(f"[20] {name}: roofline bound "
                                 f"{bound_ms:.2f} ms ({by}) above the "
                                 f"measured {card['ms']:.2f} ms")
        full = meta["peak"] / (arg_bytes + card["temp_bytes"])
        rec = {"meta": meta, "card": card, "argument_bytes_card": arg_bytes,
               "temp_ratio": ratio, "never_free_ratio": never,
               "peak_ratio": full, "bound_ms": bound_ms, "bound_by": by,
               "terms_ms": {k: 1e3 * v for k, v in terms.items()},
               "share": bound_ms / card["ms"]}
        out[f"{tag} {arch} {kind}"] = rec
        log(f"[20] {name}: matmul FLOPs {meta['matmul_flops']:,} == card; "
            f"temporaries {pred / 2**30:.3f} GiB predicted / "
            f"{card['temp_bytes'] / 2**30:.3f} GiB allocated = {ratio:.4f} "
            f"(never-free {never:.2f}), peak with arguments {full:.4f}; "
            f"bound {bound_ms:.2f} ms by {by} (compute "
            f"{rec['terms_ms']['compute']:.2f}, memory "
            f"{rec['terms_ms']['memory']:.2f}) <= {card['ms']:.2f} ms "
            f"measured: share {rec['share']:.3f}")
    report["dryrun"] = out
    free_device_memory()
    log(f"[20] passed in {time.perf_counter() - t0:.1f} s")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--quick", action="store_true",
                    help="build and check the kernels only (phases 1-2d)")
    ap.add_argument("--reps", type=int, default=5,
                    help="timed launches per measurement (after a warm-up)")
    ap.add_argument("--als-child", nargs=3, metavar=("CKPT", "OUT", "MODE"),
                    help="[13a]'s child process: cp_als with snapshots in "
                    "CKPT, results to OUT, MODE 'fresh' or 'resume'")
    ap.add_argument("--dist-child", nargs=4,
                    metavar=("CKPT", "OUT", "MODE", "SHARDS"),
                    help="[14e]'s child process: cp_als over SHARDS shards "
                    "on cuda:0, as --als-child")
    args = ap.parse_args(argv)

    import os

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    if args.als_child:
        ckpt, out, mode = args.als_child
        return als_child(ckpt or None, out, mode)
    if args.dist_child:
        ckpt, out, mode, shards = args.dist_child
        return dist_child(ckpt or None, out, mode, int(shards))
    set_env = [k for k in RESILIENCE_ENV if os.environ.get(k)]
    if set_env:
        print(f"chip_smoke: unset {', '.join(set_env)}: phases [1]-[12] "
              "run with no ladder and no injected faults", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import mttkrp as kmt
    from repro_torch.kernels import lru_scan as klru
    from repro_torch.kernels import wkv6 as kw6

    t_start = time.perf_counter()
    name, smi = phase_card()
    phase_kernels(kmt)
    phase_kernels_baseline(kmt)
    phase_wkv6(kw6)
    phase_lru(klru)
    if args.quick:
        log(f"quick run passed in {time.perf_counter() - t_start:.1f} s")
        return 0
    report = {"device": name, "nvidia_smi": smi}
    t, state0, factors, launches = main_path(kmt, report)
    twitch = phase_twitch(kmt)
    rows, errs = phase_times(kmt, t, state0, factors, report, args.reps)
    nell1 = "nell1 (scale 0.1, compact, R 32)"
    per_kernel = {k: (rows, nell1) for k in errs}
    coo = (t.indices, t.values, t.dims)
    oracle = mttkrp_oracle(torch.from_numpy(t.indices).cuda(),
                           torch.from_numpy(t.values).cuda(), factors,
                           t.dims)
    del state0
    rows7, errs7, launches7 = phase_cuda_compact(
        kmt, coo, factors, oracle, report["nell1"]["torch_fits"],
        report["nell1"]["fit_witness"], report, args.reps)
    per_kernel["mttkrp_fused_compact"] = (rows7, nell1)
    t21 = time.perf_counter()
    phase_rotation_graph(kmt, t, factors, oracle, report)
    del oracle
    log(f"[21] {time.perf_counter() - t21:.1f} s")
    coo8, cache8, rows8, errs8, launches8 = phase_rect(kmt, report,
                                                       args.reps)
    for k in RECT_NEW:
        per_kernel[k] = (rows8, "nell1 (scale 0.01, rect, R 32)")
    phase_autotune(coo8, cache8, report)
    del cache8
    wkv = phase_rwkv(kw6, report, args.reps)
    lru = phase_rg(klru, report, args.reps)
    vast = phase_stream(kmt, t, factors, report)
    counts = resilience_counts()
    if any(counts.values()):
        raise AssertionError(f"phases [1]-[12] took resilience steps: "
                             f"{counts}")
    log(f"[1]-[12] no degradation, retry, recovery or injected fault: "
        f"{counts}")
    phase_resilience(kmt, t, factors, vast, report)
    del vast
    times14, launches14, err14 = phase_dist(kmt, t, factors, coo8, twitch,
                                            report, args.reps)
    del coo8, twitch
    lm_reps = min(args.reps, LM_REPS)
    phase_dense(report, lm_reps)
    wbwd, lbwd = phase_train(kw6, klru, report, args.reps)
    launches17, kernels17 = phase_shard(report, args.reps)
    phase_moe(report, lm_reps)
    phase_families(report, lm_reps)
    phase_dryrun(report)
    kernels = kernels_record(per_kernel,
                             {**launches, **launches7, **launches8},
                             {**errs, **errs7, **errs8}) + [
        wkv6_record(wkv), lru_scan_record(lru),
        bwd_record("wkv6_bwd", wbwd,
                   f"one launch at layer 0's shape of the {RWKV_ARCH} "
                   f"prefill (B {RWKV_BATCH}, S {RWKV_SEQ}: BH 160); "
                   "train_step: the same at a training step's shape (B "
                   f"{RWKV_TRAIN_BATCH}, S {TRAIN_SEQ}: BH 80); launches: "
                   f"[16c]'s {RWKV_TRAIN_STEPS} train steps at B "
                   f"{RWKV_TRAIN_BATCH}, one a layer a step; library_ms "
                   "null: no single PyTorch call computes a WKV backward"),
        bwd_record("lru_scan_bwd", lbwd,
                   f"one launch at layer 0's shape of the {RG_ARCH} "
                   f"prefill (B {RG_BATCH}, S {RG_SEQ}); launches: [16d]'s "
                   f"{RG_TRAIN_STEPS} train steps on {RG_TRAIN_LAYERS} "
                   "layers, one a rec layer a step; library_ms null: no "
                   "single PyTorch call computes a linear recurrence's "
                   "backward")]
    dist_record(kernels, times14, launches14, err14)
    for rec in kernels:
        rec["sharded_launches"] = launches17.get(rec["name"], 0)
        if rec["name"] in kernels17:
            rec["model_shard"] = {
                k: kernels17[rec["name"]][k]
                for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                          "max_abs_err")}
    report["kernels"] = kernels
    report["seconds"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(report, indent=1))
    log(f"total {report['seconds']:.1f} s")
    log(smi)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
