"""The fleet driver's wait for each shard's kernels before its host copies, in
ms a record: the program's ``fleet.wait`` spans in the window over its
records."""

from perfbench.lib.spans import per_record_ms


def read(ctx):
    return per_record_ms(ctx, 'fleet.wait')
