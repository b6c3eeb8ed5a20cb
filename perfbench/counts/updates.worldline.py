"""The generic Worldline Hammer's local updates (``generators/worldline.py``
``VortexUpdate``, ``CoexactUpdate``, ``WrappingUpdate``, any D), PyTorch's
own kernels: one step a generator step, ``thin`` a record.

Counted from what a step needs a site, whatever the PyTorch operations read
again: m (D int32 links) and v (C = D(D−1)/2 int32 plaquettes) read once and
written once (8·(D + C) B, 80 B at D=4); per plaquette component the vortex
and the coexact proposal, each a proposal word and a uniform word (half a
Philox call), with ΔS over the plaquette's four links (B4's 26 operations a
proposal); per direction the wrapping update's link term and its share of
the cycle's sum (6 operations).  The wrapping draws (two words a cycle, 2D/N
a site), the residual's rebuilding at each update, the draws made twice
(each color pass draws every site), the fleet-wide draws of rows that a
shard does not keep and the ops' rereads are not counted, so the share only
reads low.  The traffic names its D.
"""

from perfbench.lib.kernels import native
from perfbench.lib.peaks import PHILOX_OPS

OPS_PER_PROPOSAL = PHILOX_OPS // 2 + 26
OPS_PER_WRAPPING_LINK = 6


def matches(name):
    return native(name)


def count(traffic, record=None):
    """(bytes, operations) of one record's updates over all of the cell's chains."""
    D = traffic['D']
    C = D * (D - 1) // 2
    site_steps = traffic['chains'] * traffic['L'] ** D * traffic['thin']
    return (8 * (D + C) * site_steps,
            (2 * C * OPS_PER_PROPOSAL + OPS_PER_WRAPPING_LINK * D) * site_steps)
