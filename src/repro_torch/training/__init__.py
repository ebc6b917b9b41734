"""Training on one device: optimizer, loop, checkpointing, data (the
reference's ``training/`` without its sharded half: ``compression`` and
``pipeline`` need a mesh, ROADMAP item 12.3)."""
from .optimizer import OptimizerConfig
from .train_loop import (ControllerConfig, TrainController, chunked_xent,
                         init_state, make_loss_fn, make_train_step,
                         softmax_xent)
from .checkpoint import CheckpointManager
from .data import SyntheticLM

__all__ = ["OptimizerConfig", "ControllerConfig", "TrainController",
           "chunked_xent", "init_state", "make_loss_fn", "make_train_step",
           "softmax_xent", "CheckpointManager", "SyntheticLM"]
