"""Configs of the ported architectures (see :mod:`.archs`)."""
from .archs import ARCHS, NOT_PORTED, get_config, smoke

__all__ = ["ARCHS", "NOT_PORTED", "get_config", "smoke"]
