"""Lattice geometry, calculus, and the kernels (:mod:`.sweep`, :mod:`.worm`,
:mod:`.hammer`, :mod:`.worldline`, :mod:`.worldline_worm`,
:mod:`.worldline_hammer`) with their plain PyTorch twins."""

from .lattice import Lattice, Lattice2D
from . import calculus

__all__ = ['Lattice', 'Lattice2D', 'calculus']
