"""Loss, train_step factory, and the fault-tolerant training controller:
the reference's ``training/train_loop.py``.

The train state is ``{"params", "opt", "step"}``, ``params`` in the
reference's stage layout (``models.transformer.stack_layers``: each
stacked leaf a list of the stage's per-layer tensors), ``step`` a 0-d
int32 tensor on the host. A step takes gradients with
``torch.autograd.grad`` through ``models.transformer.forward`` on a view
of the params whose tensors require grad (``unstack_layers``), clips
them and updates params and moments in place (``training.optimizer``).

Under a mesh (``make_train_step(param_shardings=)``, or a
``sharding.use(ctx)`` context) the state's tensors are
``sharding.Sharded`` (``launch.specs.place_state``) and one process
drives every position: the batch is split over the dp axes; each
position gathers its fsdp dims into working copies (in the compute dtype
under ``cast_params_once``, as the reference's; else the masters'
dtype, and each layer casts at use as on one device) and runs
``transformer.forward_tp`` with the other positions of its model axis;
the loss is the global ``sum(nll * mask) / sum(mask)``; one
``torch.autograd.grad`` takes every position's gradients, which are
summed over the positions that hold replicas and kept, on each device,
only for its own blocks (``sharding.reduce_grads``); then the clip and
the update run on each piece on its device. Nothing in the step waits
on the host.
"""
from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Callable, Optional

import torch
from torch.utils.checkpoint import checkpoint

from .. import sharding
from ..launch import specs
from ..models import transformer
from ..models.common import ModelConfig, tree_of
from ..tensorized import cpd_logits
from . import optimizer as opt_lib
from .optimizer import OptimizerConfig
from .tree import each, leaves, rank, tree_map, unflatten

log = logging.getLogger("repro_torch.train")

_NEG = -1e30


def _mask_padded(lf, vocab: int):
    """Padded vocab columns (>= vocab) out of the partition function."""
    vp = lf.shape[-1]
    if vp > vocab:
        pad = torch.arange(vp, device=lf.device) >= vocab
        lf = torch.where(pad, _NEG, lf)
    return lf


def _softmax_sums(logits, targets, vocab: int):
    """(sum of the masked NLL, count of targets) over all positions."""
    lf = _mask_padded(logits.float(), vocab)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = targets.clamp_min(0).long()
    picked = lf.gather(-1, tgt[..., None])[..., 0]
    mask = (targets >= 0).float()
    return ((lse - picked) * mask).sum(), mask.sum()


def softmax_xent(logits, targets, vocab: int):
    """f32 cross-entropy; positions with target < 0 are masked; padded
    vocab rows (>= vocab) are excluded from the partition function. The
    picked logit is gathered (the reference's one-hot contraction sums
    the same single term)."""
    nll, cnt = _softmax_sums(logits, targets, vocab)
    return nll / cnt.clamp_min(1.0)


def _xent_chunk(xc, head, tc, vocab: int):
    """(sum of the chunk's masked NLL, its count of targets): the logits
    in the compute dtype, the log-partition in f32, the picked logit from
    the compute-dtype logits (as the reference's one-hot contraction with
    an f32 accumulator picks it)."""
    logits = xc @ head
    lse = torch.logsumexp(_mask_padded(logits.float(), vocab), dim=-1)
    tgt = tc.clamp_min(0).long()
    picked = logits.gather(-1, tgt[..., None])[..., 0].float()
    mask = (tc >= 0).float()
    return ((lse - picked) * mask).sum(), mask.sum()


def _xent_part(xc, hd, tc, vocab: int, j: int):
    """Vocab shard ``j``'s share of :func:`_xent_chunk`: the
    log-partition over its head columns ``j * n`` to ``(j + 1) * n``
    (padded columns, ids >= ``vocab``, lie on the last shards) and the
    picked logit where it owns the target (0 elsewhere)."""
    n = hd.shape[-1]
    logits = xc @ hd
    cols = j * n + torch.arange(n, device=logits.device)
    lse = torch.logsumexp(torch.where(cols >= vocab, _NEG, logits.float()),
                          dim=-1)
    local = tc.clamp_min(0).long() - j * n
    own = (local >= 0) & (local < n)
    got = logits.gather(-1, local.clamp(0, n - 1)[..., None])[..., 0]
    return lse, torch.where(own, got.float(), 0.0)


def _chunked_sums(xs, heads, targets, vocab: int, chunk: int = 512):
    """(sum of the masked NLL, count of targets) of :func:`chunked_xent`;
    ``xs``, ``heads`` and ``targets`` one a vocab shard (one for a whole
    head). Over shards, each shard's part of a chunk is recomputed in
    backward on its own (:func:`_xent_part`), and the parts meet on the
    first shard's device: the log-partitions by a log-sum-exp over the
    shards (the max trick), the picked logits by a sum."""
    s = xs[0].shape[1]
    cs = min(chunk, s)
    n_chunks = (s + cs - 1) // cs
    heads = [h.to(x.dtype) for h, x in zip(heads, xs)]
    grad = torch.is_grad_enabled()

    def run(fn, *args):
        if grad:
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    nll = cnt = 0.0
    for i in range(n_chunks):
        lo = min(i * cs, s - cs)
        xc = [x[:, lo:lo + cs] for x in xs]
        tc = [t[:, lo:lo + cs] for t in targets]
        if len(xs) == 1:
            part, n = run(_xent_chunk, xc[0], heads[0], tc[0], vocab)
        else:
            parts = [run(_xent_part, x, h, t, vocab, j)
                     for j, (x, h, t) in enumerate(zip(xc, heads, tc))]
            dev = xc[0].device
            lse = torch.logsumexp(torch.stack([p[0].to(dev)
                                               for p in parts]), dim=0)
            picked = sum(p[1].to(dev) for p in parts)
            mask = (tc[0] >= 0).float()
            part, n = ((lse - picked) * mask).sum(), mask.sum()
        nll, cnt = nll + part, cnt + n
    return nll, cnt


def chunked_xent(x, head, targets, vocab: int, cfg, chunk: int = 512):
    """Cross-entropy with the head matmul in a sequence-chunk loop: full
    (B, S, V) logits are never materialised, and where autograd records
    each chunk is recomputed in backward. A last chunk that S does not
    fill starts at S - chunk, as the reference's ``dynamic_slice`` clamps
    it (its overlap is counted twice there too)."""
    nll, cnt = _chunked_sums([x], [head], [targets], vocab, chunk)
    return nll / torch.clamp(cnt, min=1.0)


def _model_inputs(cfg: ModelConfig, batch) -> dict:
    """The batch's inputs to ``forward`` besides the tokens: a ``vlm``'s
    ``embeds``, an ``audio`` model's ``enc_embeds``."""
    if cfg.kind == "vlm":
        return {"embeds": batch["embeds"]}
    if cfg.kind == "audio":
        return {"enc_embeds": batch["enc_embeds"]}
    return {}


def _text_only(cfg: ModelConfig, x):
    """``x`` (B, S', ...) without a ``vlm``'s image-prefix positions,
    which carry no loss."""
    return x[:, cfg.n_img_tokens:] if cfg.kind == "vlm" else x


def make_loss_fn(cfg: ModelConfig) -> Callable:
    """``loss_fn(params, batch)``; ``params`` a ``Model`` or a ``Node``
    view (``transformer.unstack_layers``)."""

    def loss_fn(params, batch):
        targets = batch["targets"]
        kw = _model_inputs(cfg, batch)
        if cfg.cpd_embedding:
            # CPD head: logits come factored (never a dense (V, D) table)
            logits = transformer.forward(params, cfg, batch["tokens"], **kw)
            return softmax_xent(_text_only(cfg, logits), targets, cfg.vocab)
        x = transformer.forward(params, cfg, batch["tokens"],
                                return_hidden=True, **kw)
        return chunked_xent(_text_only(cfg, x),
                            transformer.head_matrix(params, cfg), targets,
                            cfg.vocab, cfg)
    return loss_fn


def loss_sums_tp(cfg: ModelConfig, views, batches):
    """(sum of the masked NLL, count of targets) of one dp slice over the
    model axis: ``views`` and ``batches`` one a shard. A vocab-split head
    takes each shard's :func:`_xent_part`; a replicated one (or the CPD
    head) computes the loss on the first shard only."""
    tokens = [b["tokens"] for b in batches]
    targets = [b["targets"] for b in batches]
    kw = {k: [_model_inputs(cfg, b)[k] for b in batches]
          for k in _model_inputs(cfg, batches[0])}
    hs = [_text_only(cfg, h)
          for h in transformer.forward_tp(views, cfg, tokens, **kw)]
    if cfg.cpd_embedding:  # CPD head: factored logits on the first shard
        return _softmax_sums(cpd_logits(views[0].embed_cpd, hs[0]),
                             targets[0], cfg.vocab)
    if transformer.vocab_split(views[0], cfg):
        heads = [transformer.head_matrix(v, cfg) for v in views]
        return _chunked_sums(hs, heads, targets, cfg.vocab)
    return _chunked_sums(hs[:1], [transformer.head_matrix(views[0], cfg)],
                         targets[:1], cfg.vocab)


def _cast_flags(params) -> list[bool]:
    """For each tensor (in :func:`leaves` order), whether its leaf's
    stacked rank is >= 2 (the leaves the working copy casts)."""
    return leaves(tree_map(lambda leaf: [rank(leaf) >= 2]
                           * len(leaves(leaf)), params))


def _step(ocfg: OptimizerConfig, grad_accum: int, enter, grads_of, finish):
    """``train_step(state, batch) -> (state, metrics)`` around a gradient
    source: ``enter(state) -> (state, fwd)`` once a step, ``grads_of(fwd,
    mb) -> (loss, [grad, ...])`` once a microbatch, ``finish(params,
    grads)`` the gradient tree in the masters' layout and dtype. The
    microbatches' gradients are summed in place and divided, then clipped
    and applied."""

    def train_step(state, batch):
        state, fwd = enter(state)
        if grad_accum == 1:
            loss, grads = grads_of(fwd, batch)
        else:
            mbs = {k: v.reshape(grad_accum, -1, *v.shape[1:])
                   for k, v in batch.items()}
            loss, grads = 0.0, None
            for i in range(grad_accum):
                li, gi = grads_of(fwd, {k: v[i] for k, v in mbs.items()})
                loss = loss + li
                if grads is None:
                    grads = gi
                else:
                    for a, b in zip(grads, gi):
                        a.add_(b)
            for g in grads:
                g.div_(grad_accum)
            loss = loss / grad_accum
        params = state["params"]
        grads, gnorm = opt_lib.clip_by_global_norm(finish(params, grads),
                                                   ocfg.grad_clip)
        new_params, new_opt, lr = opt_lib.update(grads, state["opt"],
                                                 params, ocfg)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step


def _sharded_step(cfg: ModelConfig, ocfg: OptimizerConfig, grad_accum: int,
                  ctx, param_shardings, cast_params_once: bool):
    transformer.check_tp(cfg, ctx.tp)
    pos_all = sharding.positions(ctx.mesh)
    rows = sharding.model_rows(ctx.mesh, ctx.tp_axis)

    def enter(state):
        if not sharding.is_sharded(state["params"]):
            state = specs.place_state(state, ctx, specs.state_shardings(
                state, ctx, param_shardings))
        params = state["params"]
        return state, (params, leaves(params), _cast_flags(params))

    def grads_of(fwd, mb):
        """The loss and every position's gradients, position-major."""
        params, flat, flags = fwd
        placed = sharding.place(mb, specs.batch_shardings(cfg, mb, ctx), ctx)
        work = {}
        for pos in pos_all:
            work[pos] = [sharding.working_copy(
                s, pos, ctx, cfg.cdtype if cast_params_once and f
                and s.is_floating_point() else None).detach()
                .requires_grad_(True) for s, f in zip(flat, flags)]
        nlls, cnts = [], []
        for row in rows:
            views = [transformer.unstack_layers(cfg,
                                                unflatten(params, work[p]))
                     for p in row]
            batches = [{k: v.at(p) for k, v in placed.items()} for p in row]
            nll, cnt = loss_sums_tp(cfg, views, batches)
            nlls.append(nll)
            cnts.append(cnt)
        dev = nlls[0].device
        nll = sum(x.to(dev) for x in nlls)
        cnt = sum(x.to(dev) for x in cnts)
        loss = nll / torch.clamp(cnt, min=1.0)
        req = [t for p in pos_all for t in work[p]]
        return loss.detach(), list(torch.autograd.grad(
            loss, req, materialize_grads=True))

    def finish(params, grads):
        flat = leaves(params)
        n = len(flat)
        return unflatten(params, [sharding.reduce_grads(
            s, {p: grads[k * n + i] for k, p in enumerate(pos_all)}, ctx)
            for i, s in enumerate(flat)])

    return _step(ocfg, grad_accum, enter, grads_of, finish)


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                    grad_accum: int = 1, param_shardings=None,
                    cast_params_once: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    is updated in place and returned.

    ``grad_accum`` > 1 splits the batch into microbatches on the leading
    axis, taken in a Python loop (one microbatch's activations live at a
    time), the gradients summed, then divided. ``cast_params_once`` makes
    one working copy in the compute dtype of the leaves of stacked rank
    >= 2 at step entry, takes the gradients of those copies and casts them
    back to float32 for the update. ``metrics``: ``loss`` and
    ``grad_norm`` (0-d tensors on the device), ``lr`` (a float).

    Under a sharding context (``sharding.use(ctx)`` when the step is made)
    the step is the sharded one (see the module docstring; its working
    copies are in the compute dtype with ``cast_params_once``, else in
    the masters' dtype, cast at use as on one device), and
    ``param_shardings``
    (a tree of specs, ``sharding.param_sharding_tree``'s by default)
    places a state that is not placed yet. ``param_shardings`` without a
    context raises ``ValueError``."""
    ctx = sharding.current()
    if ctx is not None:
        return _sharded_step(cfg, ocfg, grad_accum, ctx, param_shardings,
                             cast_params_once)
    if param_shardings is not None:
        raise ValueError("param_shardings needs a mesh: make the step "
                         "under sharding.use(ctx)")
    loss_fn = make_loss_fn(cfg)

    def cast(leaf):
        if rank(leaf) < 2:
            return leaf
        return each(lambda p: p.to(cfg.cdtype) if p.is_floating_point()
                    else p, leaf)

    def enter(state):
        params = state["params"]
        return state, tree_map(cast, params) if cast_params_once else params

    def grads_of(fwd, mb):
        req = [x.detach().requires_grad_(True) for x in leaves(fwd)]
        view = transformer.unstack_layers(cfg, unflatten(fwd, req))
        loss = loss_fn(view, mb)
        return loss.detach(), list(torch.autograd.grad(
            loss, req, materialize_grads=True))

    def finish(params, grads):
        # grads back to the masters' dtype for the update
        return unflatten(params, [g.to(p.dtype) if g.dtype != p.dtype else g
                                  for g, p in zip(grads, leaves(params))])

    return _step(ocfg, grad_accum, enter, grads_of, finish)


def init_state(cfg: ModelConfig, ocfg: OptimizerConfig, seed: int = 0,
               device="cuda") -> dict:
    """``models.transformer.init_model`` on ``device`` from ``seed``, in
    the stage layout, with a fresh optimizer state. Under a sharding
    context it is drawn on the mesh's first device and placed over the
    mesh (``launch.specs.place_state``)."""
    ctx = sharding.current()
    if ctx is not None:
        transformer.check_tp(cfg, ctx.tp)
        device = ctx.mesh.devices.flat[0]
    model = transformer.init_model(cfg, seed, device=device)
    params = _detached(transformer.stack_layers(cfg, tree_of(model)))
    state = {"params": params, "opt": opt_lib.init(params, ocfg),
             "step": torch.zeros((), dtype=torch.int32)}
    return state if ctx is None else specs.place_state(state, ctx)


def _detached(tree):
    """Plain tensors (``detach``: the storage shared) in place of a
    module's parameters."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_detached(v) for v in tree]
    return tree.detach()


def _sync(x) -> None:
    if isinstance(x, torch.Tensor) and x.is_cuda:
        torch.cuda.synchronize(x.device)


# --------------------------------------------------------------------------
# Fault-tolerant controller (checkpoint/auto-resume/straggler watchdog)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class ControllerConfig:
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_torch_ckpt")
    ckpt_every: int = 50
    keep: int = 3
    async_save: bool = True
    straggler_factor: float = 3.0   # step slower than factor*median -> flag


class TrainController:
    """Runs the training loop with checkpoint/restart fault tolerance.

    - atomically checkpoints (params, opt, step, data cursor) every N steps;
    - auto-resumes from the newest checkpoint on (re)start — preemption
      recovery is "rerun the binary";
    - straggler watchdog: flags steps slower than ``factor x`` running
      median.
    """

    def __init__(self, cfg: ModelConfig, ocfg: OptimizerConfig,
                 ctrl: ControllerConfig, data_iter, train_step=None,
                 state=None, seed: int = 0, device="cuda"):
        from .checkpoint import CheckpointManager

        self.cfg, self.ocfg, self.ctrl = cfg, ocfg, ctrl
        self.data = data_iter
        self.step_fn = train_step or make_train_step(cfg, ocfg)
        self.mgr = CheckpointManager(ctrl.ckpt_dir, keep=ctrl.keep,
                                     async_save=ctrl.async_save)
        self.state = state
        if self.state is None:
            self.state = init_state(cfg, ocfg, seed, device=device)
            ctx = sharding.current()
            restored = self.mgr.restore_latest(
                like=self.state, shardings=None if ctx is None
                else specs.state_shardings(self.state, ctx))
            if restored is not None:
                self.state, data_state = restored
                self.data.set_state(data_state)
                log.info("auto-resumed at step %s", int(self.state["step"]))
        self.durations: list[float] = []
        self.straggler_steps: list[int] = []

    def run(self, num_steps: int, fail_at: Optional[int] = None):
        """Train; ``fail_at`` injects a simulated preemption (tests)."""
        metrics = None
        while int(self.state["step"]) < num_steps:
            step = int(self.state["step"])
            if fail_at is not None and step == fail_at:
                raise InterruptedError(f"simulated preemption at {step}")
            t0 = time.monotonic()
            batch = self.data.next()
            self.state, metrics = self.step_fn(self.state, batch)
            _sync(metrics["loss"])
            dt = time.monotonic() - t0
            self._watch(step, dt)
            if (step + 1) % self.ctrl.ckpt_every == 0:
                self.mgr.save(self.state, self.data.get_state())
        self.mgr.save(self.state, self.data.get_state())
        self.mgr.wait()
        return self.state, metrics

    def _watch(self, step: int, dt: float):
        self.durations.append(dt)
        hist = sorted(self.durations[-50:])
        med = hist[len(hist) // 2]
        if len(self.durations) > 5 and dt > self.ctrl.straggler_factor * med:
            self.straggler_steps.append(step)
            log.warning("straggler step %d: %.3fs (median %.3fs)",
                        step, dt, med)


__all__ = ["ControllerConfig", "TrainController", "chunked_xent",
           "init_state", "loss_sums_tp", "make_loss_fn", "make_train_step",
           "softmax_xent"]
