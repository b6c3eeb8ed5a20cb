"""The generic Villain updates' share of their roofline, in %
(``perfbench/counts/updates.villain.py``): their counted least time over the
device time of PyTorch's own kernels."""

from perfbench.lib.readers import roofline


def read(ctx):
    return roofline(ctx, 'updates.villain')
