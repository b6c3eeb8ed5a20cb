"""The generic Worldline updates' share of their roofline, in %
(``perfbench/counts/updates.worldline.py``): their counted least time over the
device time of PyTorch's own kernels."""

from perfbench.lib.readers import roofline


def read(ctx):
    return roofline(ctx, 'updates.worldline')
