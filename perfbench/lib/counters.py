"""The program's counters (``supervillain_tpu_torch.tracing.counters()``).

Read from the program that :func:`perfbench.lib.program.load` imported: this
module imports nothing anew, and a program without the counters reads
nothing.  The counters are the process's since the program was imported (the
warm-up call included), so every metric read from them is a ratio of two.
"""

from __future__ import annotations

import sys

MODULE = 'supervillain_tpu_torch.tracing'


def snapshot():
    """The program's counters, or None where it keeps none."""
    module = sys.modules.get(MODULE)
    return None if module is None else module.counters()


def ratio(numerator, denominator, scale=1.0):
    """``scale`` · counter ``numerator`` / counter ``denominator``; None where
    either is not counted or the denominator is 0."""
    counted = snapshot()
    if counted is None or numerator not in counted or not counted.get(denominator):
        return None
    return scale * counted[numerator] / counted[denominator]
