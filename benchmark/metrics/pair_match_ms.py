"""pair_match_ms: device milliseconds a chunk of ``chunk_local``'s part
``pair_match`` (all-pairs matching, the filters with K5, the residual
cap), between the program's device stamps around it; the median over the
window's kept chunks (``benchmark/timeline.py``)."""

from benchmark import timeline


def read(ctx):
    return timeline.median_ms(timeline.device_s(tl, "pair_match") for _, tl in timeline.kept(ctx.window))
