from .autocorrelation import autocorrelation, autocorrelation_time
from .blocking import Blocking
from .bootstrap import Bootstrap
from .uncertain import Uncertain
from . import scaling

__all__ = ['autocorrelation', 'autocorrelation_time', 'Blocking', 'Bootstrap', 'Uncertain',
           'scaling']
