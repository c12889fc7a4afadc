"""global_dense_ms: device milliseconds a chunk of the global solve's dense
term, the program's ``global_dense`` stamps (one span per GN iteration,
inside ``global_solve``) summed; the median over the window's kept chunks
(``benchmark/timeline.py``). None where the program stamps no such span."""

from benchmark import timeline


def dense_s(tl: dict) -> float | None:
    """The chunk's dense-term seconds, or None where it has no stamps."""
    spans = tl.get("device_iters", {}).get("global_dense")
    return sum(e - b for b, e in spans) if spans else None


def read(ctx):
    return timeline.median_ms(dense_s(tl) for _, tl in timeline.kept(ctx.window))
