from .fleet import Fleet, sample_fleet
from .fused_fleet import TRUNCATION_BUDGET, check_truncation_budget, sample_fused_fleet

__all__ = ['Fleet', 'TRUNCATION_BUDGET', 'check_truncation_budget', 'sample_fleet',
           'sample_fused_fleet']
