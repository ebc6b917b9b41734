"""Configs of the ported architectures (see :mod:`.archs`) and the
reference's input shapes (:mod:`.shapes`)."""
from .archs import ARCHS, get_config, smoke
from .shapes import SHAPES, SUBQUADRATIC_ARCHS, ShapeSpec, applicable, cells

__all__ = ["ARCHS", "SHAPES", "SUBQUADRATIC_ARCHS",
           "ShapeSpec", "applicable", "cells", "get_config", "smoke"]
