"""Arithmetic shared by the per-layer metrics' readers (``perfbench/metrics/``).

A reader gets a :class:`perfbench.run.Context`: the trace of the window, its
records in order (each with its seconds and, where its call completed in the
window, its worm moves) and the cell's traffic.  A reader that finds nothing
to read returns None, and the run leaves its metric out.
"""

from __future__ import annotations

import numpy as np


def roofline(ctx, kernel):
    """A kernel's share of its roofline, in %: the least time of its calls in
    the window's records (each call's count over one card's peaks) over the
    device time of its launches, found by name and summed over the cards."""
    counts = ctx.counts(kernel)
    seconds = ctx.trace.seconds(counts.matches)
    least = [ctx.least_seconds(kernel, r) for r in ctx.records]
    if seconds <= 0 or not least or any(x is None for x in least):
        return None
    return 100 * sum(least) / seconds


def per_record_launches(ctx, kernel):
    """[(record, device seconds)] pairing each record with its one launch of
    ``kernel`` on a one-card cell, for the records whose counts are known;
    None where the launches and the records do not pair one to one."""
    ops = ctx.trace.ops(ctx.counts(kernel).matches)
    if len(ctx.cards) != 1 or len(ops) != len(ctx.records):
        return None
    return [(r, (e - s) / 1e6) for r, (_, _, s, e) in zip(ctx.records, ops) if 'moves' in r]


def walk_roofline(ctx, kernel):
    """:func:`roofline` of a worm, over the records whose moves are known."""
    pairs = per_record_launches(ctx, kernel)
    if not pairs:
        return None
    seconds = sum(t for _, t in pairs)
    if seconds <= 0:
        return None
    return 100 * sum(ctx.least_seconds(kernel, r) for r, _ in pairs) / seconds


def percentile(values, q):
    return float(np.percentile(values, q)) if values else None
