from .core import Observable, Scalar, registry
from .action import ActionDensity
from .links import Links
from .winding import WindingSquared

__all__ = ['Observable', 'Scalar', 'registry', 'ActionDensity', 'Links', 'WindingSquared']
