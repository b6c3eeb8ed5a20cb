"""B4's share of its roofline, in % (``perfbench/counts/sweep.worldline.py``)."""

from perfbench.lib.readers import roofline


def read(ctx):
    return roofline(ctx, 'sweep.worldline')
