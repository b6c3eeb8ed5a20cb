"""The fleet driver's blocking waits on a card a record: each shard's wait for
its kernels and each copy of a card's tensor to the host, a call's final
fields included (the program's counters ``fleet.syncs`` over
``fleet.records``)."""

from perfbench.lib.counters import ratio


def read(ctx):
    return ratio('fleet.syncs', 'fleet.records')
