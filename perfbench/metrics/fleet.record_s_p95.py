"""The 95th percentile of the traced window's record times, in s: the fleet
driver's stalls, in cells whose windows hold too few records for the
end-to-end tail."""

from perfbench.lib.readers import percentile


def read(ctx):
    return percentile([r['seconds'] for r in ctx.records], 95)
