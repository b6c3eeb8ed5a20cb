from .base import Generator
from .villain import NeighborhoodUpdate, ExactNeighborhoodUpdate, ClassicWorm
from .villain_fused import (FusedNeighborhoodUpdate, FusedExactNeighborhoodUpdate,
                            FusedHammer, FusedClassicWorm)

__all__ = ['Generator', 'NeighborhoodUpdate', 'ExactNeighborhoodUpdate', 'ClassicWorm',
           'FusedNeighborhoodUpdate', 'FusedExactNeighborhoodUpdate', 'FusedHammer',
           'FusedClassicWorm']
