from . import distributed
from .fleet import TRUNCATION_BUDGET, Fleet, check_truncation_budget, sample_fleet
from .fused_fleet import sample_fused_fleet
from .mesh import ChainMesh, ChainSpaceMesh, chain_mesh, chain_space_mesh, fleet_sharding

__all__ = ['ChainMesh', 'ChainSpaceMesh', 'Fleet', 'TRUNCATION_BUDGET', 'chain_mesh',
           'chain_space_mesh', 'check_truncation_budget', 'distributed', 'fleet_sharding',
           'sample_fleet', 'sample_fused_fleet']
