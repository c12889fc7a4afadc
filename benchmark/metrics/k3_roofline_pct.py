"""k3_roofline_pct: kernel K3's share of its roofline over the traced
slice: the least time of each assembly (both launches), from the frozen
count at the shape of the stage that runs it (``counts/k3.py``), summed,
over K3's device time there."""

from benchmark.counts import k3


def read(ctx):
    t = ctx.trace
    if not t:
        return None
    least = spent = 0.0
    for stage, (n, slots, index_bytes) in k3.shapes(ctx.config["bundling"]).items():
        rows = t["our_kernels_raw"].get(f"assemble pass 2 in {stage}")
        flags = t["our_kernels_raw"].get(f"assemble pass 1 in {stage}")
        if not rows:
            continue
        least += rows["count"] * k3.least_ms(n, slots, index_bytes)[0]
        spent += rows["ms"] + (flags["ms"] if flags else 0.0)
    return 100.0 * least / spent if spent > 0 else None
