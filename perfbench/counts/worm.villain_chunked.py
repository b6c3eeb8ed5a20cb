"""K1, the chunked worm (``csrc/worm.cu`` ``chunked_worm_kernel``): one call a
generator step, ``thin`` a record.

Counted from the micro-moves a call makes, 64 a chain (a close and restart,
or a move of the head), each at the classic worm's (B2's) rate: the crossed
link's n and φ at its two ends read, the link written (16 B) and the
histogram entry of the head's displacement tallied (a read and a write, 8 B);
a Philox call, the link's residual and ΔS and the tally.  Per chain the call
reads and writes its carried worm (2 × 20 B) and returns its moves and closes
(8 B).  The wrapper's copy of the whole of n and its zeroing of the histogram
are not the walk's work and are not counted, so the share stays below 100%
for a kernel that runs in place.
"""

from perfbench.lib.kernels import base_name
from perfbench.lib.peaks import PHILOX_OPS

MOVES_PER_CALL = 64
OPS_PER_MOVE = PHILOX_OPS + 25
BYTES_PER_MOVE = 24
BYTES_PER_CHAIN = 48


def matches(name):
    return base_name(name) == 'chunked_worm_kernel'


def count(traffic, record=None):
    """(bytes, operations) of one record's worm calls over all of the cell's chains."""
    B, calls = traffic['chains'], traffic['thin']
    moves = MOVES_PER_CALL * B * calls
    return BYTES_PER_MOVE * moves + BYTES_PER_CHAIN * B * calls, OPS_PER_MOVE * moves
