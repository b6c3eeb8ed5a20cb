"""B1's share of its roofline, in % (``perfbench/counts/sweep.villain.py``)."""

from perfbench.lib.readers import roofline


def read(ctx):
    return roofline(ctx, 'sweep.villain')
