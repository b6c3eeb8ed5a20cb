"""The page-locked host memory the fleet driver had to pin anew, in MB a
record: what the process's pinned cache could not serve from the blocks of
freed fleets (the program's counters ``fleet.pinned_new_bytes`` over
``fleet.records``; the warm-up call's pinning included)."""

from perfbench.lib.counters import ratio


def read(ctx):
    return ratio('fleet.pinned_new_bytes', 'fleet.records', 1e-6)
