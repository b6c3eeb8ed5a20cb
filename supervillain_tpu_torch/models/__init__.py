from .villain import Villain
from .worldline import Worldline

__all__ = ['Villain', 'Worldline']
