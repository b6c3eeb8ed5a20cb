"""K2, the Worldline site worm at D >= 3 (``csrc/worldline_worm_general.cu``
``general_worm_kernel``): one call a generator step, ``thin`` a record.

Counted from the moves the walks took, which the program counts on the card
(``worm.worldline.moves``, ``worm.worldline.worms`` and
``worm.worldline.calls``, :mod:`perfbench.lib.counters`): the counters are
the process's, the warm-up call's included, so a call's work is their mean
over the calls.  Each move, as B5's (``counts/worm.worldline.py``): the
crossed link's m and δv/W read and m written (12 B) and the histogram entry
of the head's displacement read and written (8 B); a Philox call, the link's
residual, ΔS, the Metropolis test and the tally (B5's 25 operations), and
the flat-index arithmetic of a runtime D that B5 does not do: the axis's
stride (D − 1 multiplies at most) and two steps of a flat index, the head's
and the displacement's (a division, a modulo, a compare, a select and an add
each).  A worm's start: its Philox calls (one, and one more for every four
coordinates past the third) and a multiply-add a coordinate; per worm the
call returns its length and truncation (8 B).  Not counted: the rollback
log (a 32-bit word every 32 // ⌈log₂ 2D⌉ accepted moves), the replay of a
truncated worm, and the wrapper's copy of m, its δv/W and the histogram's
zeroing, which are not the walk's work; the share only reads low.  A program
that does not count its worms counts nothing here.
"""

from perfbench.lib import counters
from perfbench.lib.kernels import base_name
from perfbench.lib.peaks import PHILOX_OPS

BYTES_PER_MOVE = 20
BYTES_PER_WORM = 8


def ops_per_move(D):
    return PHILOX_OPS + 25 + (D - 1) + 2 * 5


def ops_per_start(D):
    return PHILOX_OPS * (1 + max(0, -(-(D - 3) // 4))) + 2 * D


def matches(name):
    return base_name(name) == 'general_worm_kernel'


def per_call(traffic):
    """(bytes, operations) of one call over all of the cell's chains, from the
    counters' mean call; None where the program counts no calls."""
    counted = counters.snapshot()
    if not counted or not counted.get('worm.worldline.calls'):
        return None
    calls, D = counted['worm.worldline.calls'], traffic['D']
    moves = counted['worm.worldline.moves'] / calls
    worms = counted['worm.worldline.worms'] / calls
    return (BYTES_PER_MOVE * moves + BYTES_PER_WORM * worms,
            ops_per_move(D) * moves + ops_per_start(D) * worms)


def count(traffic, record=None):
    """(bytes, operations) of one record's worm calls, ``thin`` mean calls."""
    call = per_call(traffic)
    return None if call is None else tuple(traffic['thin'] * x for x in call)
