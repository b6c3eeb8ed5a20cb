"""The share of B1's resident cycles spent waiting at cluster barriers, in %:
thread 0 of every block, summed over the traced calls (the program's
counters ``sweep.villain.barrier_cycles`` over ``sweep.villain.cycles``,
which it counts only while a profiler records)."""

from perfbench.lib.counters import ratio


def read(ctx):
    return ratio('sweep.villain.barrier_cycles', 'sweep.villain.cycles', 100.0)
