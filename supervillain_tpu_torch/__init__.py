"""PyTorch and CUDA port of supervillain_tpu: the Villain and Worldline fused
Hammer fleets and the general generators (every eager update, the combinators,
both ``Hammer``s and ``sample_fleet``) on one GPU, their observables, the
bootstrap and HDF5 I/O.

The fused sweep and worm kernels are CUDA C++ for Hopper (``csrc/``), built at
first use; every kernel has a plain PyTorch twin that runs for tensors on the
CPU.  Entry points, measurements and the bootstrap run on the card unless the
caller passes ``device='cpu'``.  This package never imports JAX, and importing
it needs no ``h5py``.
"""

from .ops import Lattice, Lattice2D
from .models import Villain, Worldline
from . import generators
from .generators import (Generator, DoNothing, Sequentially, KeepEvery, Logger, SiteUpdate,
                         LinkUpdate, ExactUpdate, CohomologyUpdate, NeighborhoodUpdate,
                         ExactNeighborhoodUpdate, ClassicWorm, ChunkedWorm,
                         FusedNeighborhoodUpdate, FusedExactNeighborhoodUpdate, FusedHammer,
                         FusedClassicWorm, FusedWorldlineUpdate, FusedWorldlineWorm,
                         FusedWorldlineHammer)
from .configurations import Configurations
from .ensemble import Ensemble
from . import observables
from .analysis import Blocking, Bootstrap, Uncertain, autocorrelation, autocorrelation_time
from .parallel import Fleet, sample_fleet, sample_fused_fleet
from . import io, h5

__all__ = [
    'Lattice', 'Lattice2D', 'Villain', 'Worldline', 'generators', 'Generator', 'DoNothing',
    'Sequentially', 'KeepEvery', 'Logger', 'SiteUpdate', 'LinkUpdate', 'ExactUpdate',
    'CohomologyUpdate', 'NeighborhoodUpdate', 'ExactNeighborhoodUpdate', 'ClassicWorm',
    'ChunkedWorm', 'FusedNeighborhoodUpdate',
    'FusedExactNeighborhoodUpdate', 'FusedHammer', 'FusedClassicWorm', 'FusedWorldlineUpdate',
    'FusedWorldlineWorm', 'FusedWorldlineHammer', 'Configurations', 'Ensemble', 'observables',
    'Blocking', 'Bootstrap', 'Uncertain', 'autocorrelation', 'autocorrelation_time', 'Fleet',
    'sample_fleet', 'sample_fused_fleet', 'io', 'h5',
]
