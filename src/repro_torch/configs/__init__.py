"""Configs of the ported architectures (see :mod:`.archs`) and the
reference's input shapes (:mod:`.shapes`)."""
from .archs import ARCHS, NOT_PORTED, get_config, smoke
from .shapes import SHAPES, SUBQUADRATIC_ARCHS, ShapeSpec, applicable, cells

__all__ = ["ARCHS", "NOT_PORTED", "SHAPES", "SUBQUADRATIC_ARCHS",
           "ShapeSpec", "applicable", "cells", "get_config", "smoke"]
