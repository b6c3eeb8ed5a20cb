from .core import Observable, Scalar, registry
from .action import ActionDensity
from .winding import WindingSquared

__all__ = ['Observable', 'Scalar', 'registry', 'ActionDensity', 'WindingSquared']
