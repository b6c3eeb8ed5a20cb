from .base import Generator, DoNothing
from .combining import Sequentially, KeepEvery
from .monitor import Logger
from .villain import (SiteUpdate, LinkUpdate, ExactUpdate, CohomologyUpdate, NeighborhoodUpdate,
                      ExactNeighborhoodUpdate, ClassicWorm, ChunkedWorm)
from .villain_fused import (FusedNeighborhoodUpdate, FusedExactNeighborhoodUpdate,
                            FusedHammer, FusedClassicWorm)
from . import villain, worldline
from .worldline_fused import FusedWorldlineUpdate, FusedWorldlineWorm, FusedWorldlineHammer

__all__ = ['Generator', 'DoNothing', 'Sequentially', 'KeepEvery', 'Logger', 'SiteUpdate',
           'LinkUpdate', 'ExactUpdate', 'CohomologyUpdate', 'NeighborhoodUpdate',
           'ExactNeighborhoodUpdate', 'ClassicWorm', 'ChunkedWorm', 'FusedNeighborhoodUpdate',
           'FusedExactNeighborhoodUpdate', 'FusedHammer', 'FusedClassicWorm', 'villain',
           'worldline', 'FusedWorldlineUpdate', 'FusedWorldlineWorm', 'FusedWorldlineHammer']
