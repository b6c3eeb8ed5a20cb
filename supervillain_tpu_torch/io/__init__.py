"""HDF5 I/O in the JAX package's schema (:mod:`.h5`) and generic object
persistence (:mod:`.data`).  Importing it needs no ``h5py``: the functions
that read or write import it."""

from .h5 import (
    ensemble_to_h5, ensemble_from_h5, ensemble_extend_h5, fleet_to_h5, fleet_from_h5,
    fleet_extend_h5, generator_spec, generator_from_spec, action_from_h5, check_version,
)
from .data import write, read, register, ReadWriteable, readwriteable_registry


def _register_framework_classes():
    """Framework classes with their own typed to_h5/from_h5 schema participate
    in generic :func:`write`/:func:`read` dispatch."""
    from ..ops import Lattice, Lattice2D
    from ..models import Villain, Worldline
    from ..ensemble import Ensemble
    for cls in (Lattice, Lattice2D, Villain, Worldline, Ensemble):
        register(cls)


_register_framework_classes()
