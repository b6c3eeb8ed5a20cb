"""B5, the Worldline site worm (``csrc/worldline_worm.cu`` ``worm_kernel<…>``):
one call a record.

Counted from the moves the walk took (the record's ``Worm_Length`` summed
over the chains, plus a close move for each worm that closed): each move
reads the crossed link's m and δv/W and may write m (16 B), and tallies the
histogram entry of the head's displacement (8 B); per chain the call returns
its worm length and truncation (8 B).  Operations: a Philox call, the link's
residual and ΔS and the tally a move, and one Philox call a worm's start.
The wrapper's packing of m and δv/W, its unpacking and the histogram's
zeroing are not the walk's work and are not counted.
"""

from perfbench.lib.kernels import base_name, templated
from perfbench.lib.peaks import PHILOX_OPS

OPS_PER_MOVE = PHILOX_OPS + 25
BYTES_PER_MOVE = 24


def matches(name):
    return base_name(name) == 'worm_kernel' and templated(name)


def count(traffic, record):
    """(bytes, operations) of one record's worm calls, or None where the
    record's moves are not known."""
    if 'moves' not in record:
        return None
    B, moves = traffic['chains'], record['moves']
    return (BYTES_PER_MOVE * moves + 8 * B,
            OPS_PER_MOVE * moves + PHILOX_OPS * B * traffic['worms'])
