"""K2's device time over the moves of each call's longest worm, in ns: the
window's K2 launches in the trace, each with the program's mean longest worm
a call (the counters ``worm.worldline.longest`` over ``worm.worldline.calls``).
The walk is serial, so its floor is a memory round trip a move of the longest
chain, not the roofline."""

from perfbench.lib.counters import ratio


def read(ctx):
    launches = ctx.trace.ops(ctx.counts('worm.worldline_general').matches)
    longest = ratio('worm.worldline.longest', 'worm.worldline.calls')
    if not launches or not longest:
        return None
    return 1e9 * sum(e - s for _, _, s, e in launches) / 1e6 / (len(launches) * longest)
