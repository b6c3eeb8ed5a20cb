"""The whole record's share of the cards' peaks, in %: the least time of every
record of the window (its kernels' counted bytes over the memory rate or
their counted operations over the float32 rate, whichever is larger, on all
of the cell's cards) summed, over the window's wall time.  A worm's work
counts only in the records whose moves are known; elsewhere it counts 0,
which only lowers the share."""

from perfbench.lib import peaks


def read(ctx):
    if not ctx.records or ctx.trace.window_s <= 0:
        return None
    total = 0.0
    for record in ctx.records:
        nbytes = ops = 0.0
        for kernel in ctx.traffic['kernels']:
            counted = ctx.counts(kernel).count(ctx.traffic, record)
            if counted is not None:
                nbytes, ops = nbytes + counted[0], ops + counted[1]
        total += peaks.least_seconds(nbytes, ops, cards=len(ctx.cards))
    return 100 * total / ctx.trace.window_s
