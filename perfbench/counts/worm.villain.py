"""B2, the Villain classic worm (``csrc/worm.cu`` ``worm_kernel``): one call a record.

Counted from the moves the walk took (the record's ``Worm_Length`` summed
over the chains, plus a close move for each worm that closed): each move
reads the crossed link's n and φ at its two ends and may write the link (16
B), and tallies the histogram entry of the head's displacement (a read and a
write, 8 B); per chain the call returns its worm length and truncation (8 B).
Operations: a Philox call, the link's residual and ΔS and the tally a move,
and the two Philox calls of each worm's start.  The wrapper's copy of the
whole of n and its zeroing of the histogram are not the walk's work and are
not counted, so the share stays below 100% for a kernel that runs in place.
"""

from perfbench.lib.kernels import base_name, templated
from perfbench.lib.peaks import PHILOX_OPS

OPS_PER_MOVE = PHILOX_OPS + 25
BYTES_PER_MOVE = 24


def matches(name):
    return base_name(name) == 'worm_kernel' and not templated(name)


def count(traffic, record):
    """(bytes, operations) of one record's worm calls, or None where the
    record's moves are not known (its call did not complete in the window)."""
    if 'moves' not in record:
        return None
    B, moves = traffic['chains'], record['moves']
    return (BYTES_PER_MOVE * moves + 8 * B,
            OPS_PER_MOVE * moves + 2 * PHILOX_OPS * B * traffic['worms'])
