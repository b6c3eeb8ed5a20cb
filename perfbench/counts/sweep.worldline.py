"""B4, the Worldline local-update sweep (``csrc/worldline.cu``): one call a record.

Bytes: m (2 × 4 B) and v (4 B) read once and written once a site, and a
chain's accepted count and inline sum.  Operations: per site and sweep two
plaquette proposals of one Philox call and ΔS over four links each, the
wrapping terms of two links and the Σu² of the inline sum.
"""

from perfbench.lib.kernels import base_name
from perfbench.lib.peaks import PHILOX_OPS

OPS_PER_SITE_SWEEP = 2 * (PHILOX_OPS + 26) + 12
KERNELS = ('to_private', 'to_public', 'plaquette_pass', 'plaquette_pass_table', 'wrapping_pass',
           'sum_squares')


def matches(name):
    return base_name(name) in KERNELS


def count(traffic, record=None):
    """(bytes, operations) of one record's sweep calls over all of the cell's chains."""
    B, N, sweeps = traffic['chains'], traffic['L'], traffic['thin']
    sites = B * N * N
    return 24 * sites + 12 * B, OPS_PER_SITE_SWEEP * sites * sweeps
