"""Training: optimizer, loop (on one device or sharded over a mesh),
checkpointing, data, gradient compression and the pipeline schedule (the
reference's ``training/``)."""
from .optimizer import OptimizerConfig
from .train_loop import (ControllerConfig, TrainController, chunked_xent,
                         init_state, make_loss_fn, make_train_step,
                         softmax_xent)
from .checkpoint import CheckpointManager
from .data import SyntheticLM

__all__ = ["OptimizerConfig", "ControllerConfig", "TrainController",
           "chunked_xent", "init_state", "make_loss_fn", "make_train_step",
           "softmax_xent", "CheckpointManager", "SyntheticLM"]
