"""dense_roofline_pct: the global solve's dense term's share of its
roofline over the window's kept chunks: the least time of the work each
chunk's counters say it did (``counts/dense.py``), summed, over the
``global_dense`` stamps' time, summed over the same chunks."""

from benchmark import spec
from benchmark.counts import dense


def read(ctx):
    bc = ctx.config["bundling"]
    dense_s = spec.reader("global_dense_ms").dense_s
    least = spent = 0.0
    for r in spec.reader("dense_live_pct").kept_records(ctx.window):
        s = dense_s(r["timeline"])
        if s:
            least += dense.least_ms(r["dense_pairs_live"], r["dense_frames_live"], r["dense_px_valid"],
                                    r["dense_assoc_depth"], r["dense_assoc_color"], bc["global_gn_iters"],
                                    bc["cache_width"] * bc["cache_height"])[0]
            spent += s * 1e3
    return 100.0 * least / spent if spent > 0 else None
