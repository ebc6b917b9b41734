"""Loss, train_step factory, and the fault-tolerant training controller:
the reference's ``training/train_loop.py`` on one device.

The train state is ``{"params", "opt", "step"}``, ``params`` in the
reference's stage layout (``models.transformer.stack_layers``: each
stacked leaf a list of the stage's per-layer tensors), ``step`` a 0-d
int32 tensor on the host. A step takes gradients with
``torch.autograd.grad`` through ``models.transformer.forward`` on a view
of the params whose tensors require grad (``unstack_layers``), clips
them and updates params and moments in place (``training.optimizer``).
The reference's ``sharding.shard(...)`` calls are no-ops without a mesh
context and are dropped; ``param_shardings`` and the mesh are the
sharded half of ROADMAP item 12.3.
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

from ..models import transformer
from ..models.common import ModelConfig, tree_of
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


def softmax_xent(logits, targets, vocab: int):
    """f32 cross-entropy; positions with target < 0 are masked; padded
    vocab rows (>= vocab) are excluded from the partition function. The
    picked logit is gathered (the reference's one-hot contraction sums
    the same single term)."""
    lf = _mask_padded(logits.float(), vocab)
    lse = torch.logsumexp(lf, dim=-1)
    tgt = targets.clamp_min(0).long()
    picked = lf.gather(-1, tgt[..., None])[..., 0]
    mask = (targets >= 0).float()
    return ((lse - picked) * mask).sum() / mask.sum().clamp_min(1.0)


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


def chunked_xent(x, head, targets, vocab: int, cfg, chunk: int = 512):
    """Cross-entropy with the head matmul in a sequence-chunk loop: full
    (B, S, V) logits are never materialised, and where autograd records
    each chunk is recomputed in backward. A last chunk that S does not
    fill starts at S - chunk, as the reference's ``dynamic_slice`` clamps
    it (its overlap is counted twice there too)."""
    b, s, d = x.shape
    cs = min(chunk, s)
    n_chunks = (s + cs - 1) // cs
    hd = head.to(x.dtype)
    grad = torch.is_grad_enabled()
    nll = cnt = 0.0
    for i in range(n_chunks):
        lo = min(i * cs, s - cs)
        xc, tc = x[:, lo:lo + cs], targets[:, lo:lo + cs]
        if grad:
            part, n = checkpoint(_xent_chunk, xc, hd, tc, vocab,
                                 use_reentrant=False)
        else:
            part, n = _xent_chunk(xc, hd, tc, vocab)
        nll, cnt = nll + part, cnt + n
    return nll / torch.clamp(cnt, min=1.0)


def make_loss_fn(cfg: ModelConfig) -> Callable:
    """``loss_fn(params, batch)``; ``params`` a ``Model`` or a ``Node``
    view (``transformer.unstack_layers``)."""

    def loss_fn(params, batch):
        targets = batch["targets"]
        if cfg.cpd_embedding:
            # CPD head: logits come factored (never a dense (V, D) table)
            logits = transformer.forward(params, cfg, batch["tokens"])
            return softmax_xent(logits, targets, cfg.vocab)
        x = transformer.forward(params, cfg, batch["tokens"],
                                return_hidden=True)
        return chunked_xent(x, transformer.head_matrix(params, cfg),
                            targets, cfg.vocab, cfg)
    return loss_fn


def make_train_step(cfg: ModelConfig, ocfg: OptimizerConfig,
                    grad_accum: int = 1,
                    cast_params_once: bool = False) -> Callable:
    """Returns ``train_step(state, batch) -> (state, metrics)``; the state
    is updated in place and returned.

    ``grad_accum`` > 1 splits the batch into microbatches on the leading
    axis, taken in a Python loop (one microbatch's activations live at a
    time), the gradients summed, then divided. ``cast_params_once`` makes
    one working copy in the compute dtype of the leaves of stacked rank
    >= 2 at step entry, takes the gradients of those copies and casts them
    back to float32 for the update. ``metrics``: ``loss`` and
    ``grad_norm`` (0-d tensors on the device), ``lr`` (a float)."""
    loss_fn = make_loss_fn(cfg)

    def cast(leaf):
        if rank(leaf) < 2:
            return leaf
        return each(lambda p: p.to(cfg.cdtype) if p.is_floating_point()
                    else p, leaf)

    def one(fwd, mb):
        req = [x.detach().requires_grad_(True) for x in leaves(fwd)]
        view = transformer.unstack_layers(cfg, unflatten(fwd, req))
        loss = loss_fn(view, mb)
        grads = torch.autograd.grad(loss, req, materialize_grads=True)
        return loss.detach(), list(grads)

    def train_step(state, batch):
        params = state["params"]
        fwd = tree_map(cast, params) if cast_params_once else params
        if grad_accum == 1:
            loss, grads = one(fwd, batch)
        else:
            mbs = {k: v.reshape(grad_accum, -1, *v.shape[1:])
                   for k, v in batch.items()}
            loss, grads = 0.0, None
            for i in range(grad_accum):
                li, gi = one(fwd, {k: v[i] for k, v in mbs.items()})
                loss = loss + li
                if grads is None:
                    grads = gi
                else:
                    for a, b in zip(grads, gi):
                        a.add_(b)
            for g in grads:
                g.div_(grad_accum)
            loss = loss / grad_accum
        # grads back to the masters' dtype for the update
        grads = [g.to(p.dtype) if g.dtype != p.dtype else g
                 for g, p in zip(grads, leaves(params))]
        grads = unflatten(params, grads)
        grads, gnorm = opt_lib.clip_by_global_norm(grads, ocfg.grad_clip)
        new_params, new_opt, lr = opt_lib.update(grads, state["opt"],
                                                 params, ocfg)
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr}
        return {"params": new_params, "opt": new_opt,
                "step": state["step"] + 1}, metrics

    return train_step


def init_state(cfg: ModelConfig, ocfg: OptimizerConfig, seed: int = 0,
               device="cuda") -> dict:
    """``models.transformer.init_model`` on ``device`` from ``seed``, in
    the stage layout, with a fresh optimizer state."""
    model = transformer.init_model(cfg, seed, device=device)
    params = _detached(transformer.stack_layers(cfg, tree_of(model)))
    return {"params": params, "opt": opt_lib.init(params, ocfg),
            "step": torch.zeros((), dtype=torch.int32)}


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
            restored = self.mgr.restore_latest(like=self.state)
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
           "init_state", "make_loss_fn", "make_train_step", "softmax_xent"]
