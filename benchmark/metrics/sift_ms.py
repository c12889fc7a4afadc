"""sift_ms: device milliseconds a chunk of ``chunk_local``'s part ``sift``
(preprocessing, the pyramid, SIFT's detection and descriptors: K2, K4),
between the program's device stamps around it; the median over the
window's kept chunks (``benchmark/timeline.py``)."""

from benchmark import timeline


def read(ctx):
    return timeline.median_ms(timeline.device_s(tl, "sift") for _, tl in timeline.kept(ctx.window))
