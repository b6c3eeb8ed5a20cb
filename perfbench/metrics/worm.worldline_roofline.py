"""B5's share of its roofline, in %, over the records whose worm moves are
known (``perfbench/counts/worm.worldline.py``)."""

from perfbench.lib.readers import walk_roofline


def read(ctx):
    return walk_roofline(ctx, 'worm.worldline')
