"""End-to-end training driver of the port (the card by default;
``--device cpu`` runs a smoke config on the CPU, as the tests do).
Example:

  PYTHONPATH=src python -m repro_torch.launch.train --arch tinyllama-1.1b \\
      --steps 4 --batch 4 --seq 4096 --ckpt-dir ck

``--mesh 2,2`` trains sharded over a (data 2, model 2) mesh under
``sharding.use(make_ctx(mesh))``: over the first visible cards (it
raises when there are too few), or with ``--device cpu`` over CPU
devices.
"""
from __future__ import annotations

import argparse
import logging
import math
import os
import tempfile

from .. import sharding as shlib
from ..configs import get_config, smoke
from ..training import (ControllerConfig, OptimizerConfig, SyntheticLM,
                        TrainController, make_train_step)
from .mesh import make_mesh


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (tests)")
    ap.add_argument("--mesh", default=None,
                    help="e.g. '2,2' => (data=2, model=2) over the first "
                    "visible cards (CPU devices with --device cpu)")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO)

    cfg = smoke(args.arch) if args.smoke else get_config(args.arch)
    ocfg = OptimizerConfig(lr=args.lr, total_steps=args.steps,
                           warmup_steps=max(args.steps // 20, 1))
    ctrl = ControllerConfig(ckpt_dir=args.ckpt_dir,
                            ckpt_every=args.ckpt_every)
    ctx = None
    if args.mesh:
        shape = tuple(int(x) for x in args.mesh.split(","))
        axes = ("data", "model")[:len(shape)]
        devices = ([args.device] * math.prod(shape)
                   if args.device == "cpu" else None)
        ctx = shlib.make_ctx(make_mesh(shape, axes, devices))
    data = SyntheticLM(cfg, batch=args.batch, seq=args.seq,
                       device=args.device)
    with shlib.use(ctx):
        tc = TrainController(cfg, ocfg, ctrl, data,
                             train_step=make_train_step(
                                 cfg, ocfg, grad_accum=args.grad_accum),
                             device=args.device)
        state, metrics = tc.run(args.steps)
    loss = float(metrics["loss"]) if metrics else float("nan")
    print(f"done: step={int(state['step'])} loss={loss:.4f} "
          f"stragglers={tc.straggler_steps}")


if __name__ == "__main__":
    main()
