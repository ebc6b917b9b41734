"""GPipe-style pipeline parallelism over a mesh axis: the reference's
``training/pipeline.py``.

Stages live on the positions of a mesh axis (each stage's params on its
device); microbatches stream through the classic ``n_micro + n_stages -
1``-tick schedule, the activations handed to the next stage's device
each tick. One process drives every stage (``repro_torch.sharding``):
in a tick each stage that holds a microbatch runs on its own device, so
the launches of a tick overlap across devices, and a stage with none
idles (the bubble).

Not used by the train step (as in the reference); a tested primitive for
models deeper than one device's memory.
"""
from __future__ import annotations

import torch


def _stage_params(stage_params, s: int):
    if isinstance(stage_params, (list, tuple)):
        return stage_params[s]
    if isinstance(stage_params, dict):
        return {k: _stage_params(v, s) for k, v in stage_params.items()}
    return stage_params[s]


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def pipeline_apply(stage_fn, stage_params, x, *, mesh, axis: str = "pp",
                   n_micro: int):
    """Run ``y = stage_{S-1}(...stage_0(x))`` on the ``axis`` positions of
    ``mesh`` (the other axes at index 0).

    Args:
      stage_fn: (params_one_stage, h) -> h, the per-stage computation.
      stage_params: a list of the stages' params, or a tree stacked on a
        leading ``n_stages`` axis; stage ``s``'s are copied to its device.
      x: (batch, ...) input; ``n_micro`` must divide the batch.
      mesh: a :class:`~repro_torch.launch.mesh.Mesh` with ``axis`` of size
        ``n_stages``.
      n_micro: number of microbatches streamed through the pipe.

    Returns y with x's shape, on x's device.
    """
    n_stages = mesh.shape[axis]
    b = x.shape[0]
    if b % n_micro:
        raise ValueError(f"batch {b} does not divide into {n_micro} "
                         "microbatches")
    mb = b // n_micro
    k = mesh.axis_names.index(axis)
    index = [0] * len(mesh.axis_names)
    devs = []
    for s in range(n_stages):
        index[k] = s
        devs.append(mesh.devices[tuple(index)])
    params = [_to(_stage_params(stage_params, s), devs[s])
              for s in range(n_stages)]
    mbs = x.reshape(n_micro, mb, *x.shape[1:])
    carry = [None] * n_stages        # the input each stage holds
    outs = [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        if t < n_micro:
            carry[0] = mbs[t].to(devs[0])
        nxt = [None] * n_stages
        for s in range(n_stages):
            if carry[s] is None:       # a bubble
                continue
            h = stage_fn(params[s], carry[s])
            if s + 1 < n_stages:
                nxt[s + 1] = h.to(devs[s + 1])
            else:                      # the last stage retires t - (S-1)
                outs[t - (n_stages - 1)] = h.to(x.device)
        carry = nxt
    return torch.stack(outs).reshape(b, *outs[0].shape[1:])


__all__ = ["pipeline_apply"]
