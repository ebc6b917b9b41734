"""The port's functional spMTTKRP engine (see :mod:`.api`)."""
from .api import (DISPATCH_COUNTS, FoldFn, all_modes, init, mttkrp,
                  reset_counters)
from .backends import BACKENDS, get_backend, register_backend
from .config import ExecutionConfig
from .state import EngineState, ModeSched, ModeStatic

__all__ = ["init", "mttkrp", "all_modes", "reset_counters",
           "DISPATCH_COUNTS", "FoldFn", "BACKENDS", "get_backend",
           "register_backend", "ExecutionConfig",
           "EngineState", "ModeSched", "ModeStatic"]
