"""The fleet driver's host store of each record, in ms a record: the join over
the shards, the columns' allocation and the record's write into them (the
program's ``fleet.store`` spans in the window over its records)."""

from perfbench.lib.spans import per_record_ms


def read(ctx):
    return per_record_ms(ctx, 'fleet.store')
