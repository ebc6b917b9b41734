"""Batched serving: :class:`~.engine.Engine` over the decode cache."""
from .engine import Engine, ServeConfig

__all__ = ["Engine", "ServeConfig"]
