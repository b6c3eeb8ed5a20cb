"""The share of the window in which a card ran no operation, in %, averaged
over the cell's cards (copies and memsets count as busy)."""


def read(ctx):
    if not ctx.cards or ctx.trace.window_s <= 0:
        return None
    idle = [1 - ctx.trace.busy_s(c) / ctx.trace.window_s for c in ctx.cards]
    return 100 * sum(idle) / len(idle)
