"""B1, the Villain neighborhood sweep (``csrc/sweep.cu``): one call a record a card.

Bytes: φ (4 B) and n (2 × 4 B) read once and written once a site, and a
chain's accepted count and two inline sums.  Operations: per site-update two
Philox calls, ΔS over the four links, the draw conversions and the per-sweep
inline sums.  Read off the kernel's source once; the count of what the call
needs, whatever the kernel reads again.
"""

from perfbench.lib.kernels import base_name
from perfbench.lib.peaks import PHILOX_OPS

OPS_PER_SITE_UPDATE = 2 * PHILOX_OPS + 42
#: The launches of a call, by name: the resident regime's one kernel, or the
#: streaming and table regimes' passes.
KERNELS = ('resident_sweeps', 'init_residual', 'color_pass', 'color_pass_table', 'inline_sums')


def matches(name):
    return base_name(name) in KERNELS


def count(traffic, record=None):
    """(bytes, operations) of one record's sweep calls over all of the cell's chains."""
    B, N, sweeps = traffic['chains'], traffic['L'], traffic['thin']
    sites = B * N * N
    return 24 * sites + 12 * B, OPS_PER_SITE_UPDATE * sites * sweeps


