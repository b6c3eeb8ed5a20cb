"""K1's share of its roofline, in % (``perfbench/counts/worm.villain_chunked.py``)."""

from perfbench.lib.readers import roofline


def read(ctx):
    return roofline(ctx, 'worm.villain_chunked')
