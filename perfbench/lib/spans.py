"""Sums of the program's own spans in the traced window.

The program names stretches of its host time with ``torch.profiler``
spans (``supervillain_tpu_torch.tracing``), which the trace holds among its
host spans (:attr:`perfbench.lib.trace.Trace.host_spans`), on the clock of
the window and of the device's operations.  A program without a span leaves
it out of the trace, and a reader of it then reads nothing.
"""

from __future__ import annotations


def clipped_seconds(trace, name):
    """The seconds of the spans ``name``, each clipped to the window, summed;
    None where the trace holds no such span."""
    spans = [(s, e) for s, e, n in trace.host_spans if n == name]
    if not spans:
        return None
    return sum(max(0.0, min(e, trace.t1) - max(s, trace.t0)) for s, e in spans) / 1e6


def inside_seconds(trace, name):
    """The seconds of each span ``name`` that lies wholly inside the window."""
    return [(e - s) / 1e6 for s, e, n in trace.host_spans
            if n == name and s >= trace.t0 and e <= trace.t1]


def per_record_ms(ctx, name):
    """The spans ``name`` in the window, in ms a record of the window; None
    where the trace holds none or the window no record."""
    seconds = clipped_seconds(ctx.trace, name)
    if seconds is None or not ctx.records:
        return None
    return 1e3 * seconds / len(ctx.records)
