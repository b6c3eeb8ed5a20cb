"""The share of the generic Worldline worms that reached the fleet's cap and
were rolled back, in % (the program's counters ``worm.worldline.truncated``
over ``worm.worldline.worms``, which count only while the profiler records:
the traced window's calls); the fleet driver warns above 0.1%."""

from perfbench.lib.counters import ratio


def read(ctx):
    return ratio('worm.worldline.truncated', 'worm.worldline.worms', scale=100.0)
