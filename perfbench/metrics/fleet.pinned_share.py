"""The share of the bytes the fleet driver copies to the host that land in
page-locked memory, in %: the records' and the final fields' (the program's
counters ``fleet.pinned_bytes`` over ``fleet.host_bytes`` plus
``fleet.final_bytes``).  A program that does not count pinned bytes reads
nothing."""

from perfbench.lib.counters import snapshot


def read(ctx):
    counted = snapshot()
    if counted is None or 'fleet.pinned_bytes' not in counted:
        return None
    copied = counted.get('fleet.host_bytes', 0) + counted.get('fleet.final_bytes', 0)
    return 100.0 * counted['fleet.pinned_bytes'] / copied if copied else None
