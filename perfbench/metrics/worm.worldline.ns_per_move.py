"""B5's device time over the moves of each call's longest worm, in ns: the
walk is serial, so its floor is a memory round trip a move of the longest
chain, not the roofline (records whose moves are known)."""

from perfbench.lib.readers import per_record_launches


def read(ctx):
    pairs = per_record_launches(ctx, 'worm.worldline')
    if not pairs:
        return None
    longest = sum(r['longest'] for r, _ in pairs)
    return 1e9 * sum(t for _, t in pairs) / longest if longest > 0 else None
