"""The bytes the fleet driver copies to the host a record, in MB (the
program's counters ``fleet.host_bytes`` over ``fleet.records``)."""

from perfbench.lib.counters import ratio


def read(ctx):
    return ratio('fleet.host_bytes', 'fleet.records', 1e-6)
