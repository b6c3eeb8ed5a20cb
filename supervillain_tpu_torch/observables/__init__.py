"""Observable registry: importing this package registers every observable as a
descriptor on Ensemble (primaries) and Bootstrap (derived quantities)."""

from .core import (
    Observable, DerivedQuantity, Scalar, Constrained,
    OnlyVillain, OnlyWorldline, NotVillain, NotWorldline,
    registry, derived_registry, progress,
)

from .links import Links
from .energy import (
    InternalEnergyDensity, InternalEnergyDensitySquared,
    InternalEnergyDensityVariance, SpecificHeatCapacity,
)
from .action import ActionDensity, ActionTwoPoint, Action_Action
from .winding import WindingSquared, Winding_Winding
from .wrapping import TorusWrapping, WrappingSquared
from .spin import (
    Spin_Spin, Spin_Spin_Normalized, SpinSusceptibility,
    SpinSusceptibilityScaled, SpinCriticalMoment,
)
from .vortex import (
    Vortex_Vortex, Vortex_Vortex_Normalized, VortexSusceptibility,
    VortexSusceptibilityScaled, VortexCriticalMoment,
)

#: All primary observables.
observables = registry
