"""``supervillain_tpu_torch.h5``: the HDF5 surface of :mod:`.io` under the
import path the JAX package also offers (``supervillain_tpu.h5``)."""

from .io.h5 import (
    action_from_h5,
    check_version,
    generator_spec,
    generator_from_spec,
    ensemble_to_h5,
    ensemble_from_h5,
    ensemble_extend_h5,
    fleet_to_h5,
    fleet_from_h5,
    fleet_extend_h5,
)
from .io.data import write, read, register, ReadWriteable, readwriteable_registry

__all__ = [
    'action_from_h5', 'check_version', 'generator_spec', 'generator_from_spec',
    'ensemble_to_h5', 'ensemble_from_h5', 'ensemble_extend_h5', 'fleet_to_h5',
    'fleet_from_h5', 'fleet_extend_h5', 'write', 'read', 'register', 'ReadWriteable',
    'readwriteable_registry',
]
