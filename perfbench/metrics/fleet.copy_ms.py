"""Device time of the copies to the host, per record, in ms (the fleet
driver's host copy of each record's inline columns; the trace's
device-to-host memcpys in the window, summed over the cards)."""


def read(ctx):
    if not ctx.records:
        return None
    return 1e3 * ctx.trace.copies_to_host_s() / len(ctx.records)
