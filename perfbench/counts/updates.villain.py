"""The generic Villain Hammer's local updates (``generators/villain.py``
``SiteUpdate``, ``LinkUpdate``, ``ExactUpdate``, ``CohomologyUpdate``, D = 2),
PyTorch's own kernels: one step a generator step, ``thin`` a record.

Counted from what a step needs, whatever the PyTorch operations read again:
φ (4 B) and n (2 × 4 B) read once and written once a site (24 B, as B1's
count), and per site the draws of the site update (a proposal and a
uniform), of its two links' update (a proposal and a uniform each) and of the
exact update (a proposal and a uniform), eight 32-bit words or two Philox
calls, with B1's 42 operations for ΔS over the site's links.  The cohomology
update's two slices a chain, the fleet-wide draws of rows that a shard does
not keep and the record's inline sums are not counted, so the share only
reads low.
"""

from perfbench.lib.kernels import native
from perfbench.lib.peaks import PHILOX_OPS

BYTES_PER_SITE = 24
OPS_PER_SITE = 2 * PHILOX_OPS + 42


def matches(name):
    return native(name)


def count(traffic, record=None):
    """(bytes, operations) of one record's updates over all of the cell's chains."""
    site_steps = traffic['chains'] * traffic['L'] ** 2 * traffic['thin']
    return BYTES_PER_SITE * site_steps, OPS_PER_SITE * site_steps
