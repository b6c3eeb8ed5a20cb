from .base import Generator
from .villain import NeighborhoodUpdate, ExactNeighborhoodUpdate, ClassicWorm
from .villain_fused import (FusedNeighborhoodUpdate, FusedExactNeighborhoodUpdate,
                            FusedHammer, FusedClassicWorm)
from . import worldline
from .worldline_fused import FusedWorldlineUpdate, FusedWorldlineWorm, FusedWorldlineHammer

__all__ = ['Generator', 'NeighborhoodUpdate', 'ExactNeighborhoodUpdate', 'ClassicWorm',
           'FusedNeighborhoodUpdate', 'FusedExactNeighborhoodUpdate', 'FusedHammer',
           'FusedClassicWorm', 'worldline', 'FusedWorldlineUpdate', 'FusedWorldlineWorm',
           'FusedWorldlineHammer']
