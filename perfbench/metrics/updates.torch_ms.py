"""Device time of PyTorch's own kernels (``at::native`` in the name), in ms a
record: in ``sample_fleet`` the generic local updates, the fleet-wide draws and
the record's inline sums (the trace's kernels in the window, summed over the
cards, over its records).  Copies and memsets, such as K1's copy of n, are
not kernels in the trace and are not counted."""

from perfbench.lib.kernels import native


def read(ctx):
    if not ctx.records:
        return None
    seconds = sum(e - s for _, name, cat, s, e in ctx.trace.device_ops
                  if cat == 'kernel' and native(name)) / 1e6
    return 1e3 * seconds / len(ctx.records) if seconds > 0 else None
