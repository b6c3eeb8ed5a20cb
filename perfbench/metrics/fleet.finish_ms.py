"""The fleet driver's work after a call's last record, in ms: the stats, the
final fields' copy and join, the gather (the mean of the program's
``fleet.finish`` spans that lie wholly inside the window)."""

from perfbench.lib.spans import inside_seconds


def read(ctx):
    spans = inside_seconds(ctx.trace, 'fleet.finish')
    return 1e3 * sum(spans) / len(spans) if spans else None
