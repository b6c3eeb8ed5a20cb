"""PyTorch and CUDA port of supervillain_tpu: the Villain main path on one GPU.

The fused sweep and worm kernels are CUDA C++ for Hopper (``csrc/``), built at
first use; every kernel has a plain PyTorch twin that runs for tensors on the
CPU.  This package never imports JAX.
"""

from .ops import Lattice, Lattice2D
from .models import Villain
from .generators import (Generator, NeighborhoodUpdate, ExactNeighborhoodUpdate, ClassicWorm,
                         FusedNeighborhoodUpdate, FusedExactNeighborhoodUpdate, FusedHammer,
                         FusedClassicWorm)
from .configurations import Configurations
from .ensemble import Ensemble
from . import observables
from .analysis import Bootstrap, autocorrelation, autocorrelation_time
from .parallel import Fleet, sample_fused_fleet

__all__ = [
    'Lattice', 'Lattice2D', 'Villain', 'Generator', 'NeighborhoodUpdate',
    'ExactNeighborhoodUpdate', 'ClassicWorm', 'FusedNeighborhoodUpdate',
    'FusedExactNeighborhoodUpdate', 'FusedHammer', 'FusedClassicWorm', 'Configurations',
    'Ensemble', 'observables', 'Bootstrap', 'autocorrelation', 'autocorrelation_time',
    'Fleet', 'sample_fused_fleet',
]
