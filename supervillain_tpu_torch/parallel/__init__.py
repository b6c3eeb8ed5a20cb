from .fleet import Fleet
from .fused_fleet import TRUNCATION_BUDGET, check_truncation_budget, sample_fused_fleet

__all__ = ['Fleet', 'TRUNCATION_BUDGET', 'check_truncation_budget', 'sample_fused_fleet']
