"""K2's share of its roofline, in % (``perfbench/counts/worm.worldline_general.py``):
the window's K2 launches in the trace, each at the counted least time of the
program's mean call, over their device time."""

from perfbench.lib import peaks


def read(ctx):
    counts = ctx.counts('worm.worldline_general')
    launches = ctx.trace.ops(counts.matches)
    call = counts.per_call(ctx.traffic)
    seconds = sum(e - s for _, _, s, e in launches) / 1e6
    if not launches or call is None or seconds <= 0:
        return None
    return 100 * len(launches) * peaks.least_seconds(*call) / seconds
