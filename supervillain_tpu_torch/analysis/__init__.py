from .autocorrelation import autocorrelation, autocorrelation_time
from .bootstrap import Bootstrap

__all__ = ['autocorrelation', 'autocorrelation_time', 'Bootstrap']
