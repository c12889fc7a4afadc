"""idle_pct: the share of the traced slice in which no kernel, copy or fill
ran on the card (100 minus the union of the device intervals)."""


def read(ctx):
    t = ctx.trace
    return 100.0 * (1.0 - t["busy_share"]) if t else None
