"""local_ba_ms: device milliseconds a chunk of ``chunk_local``'s part
``local_ba`` (the local Gauss-Newton solve and its prunes: K3, PCG),
between the program's device stamps around it; the median over the
window's kept chunks (``benchmark/timeline.py``)."""

from benchmark import timeline


def read(ctx):
    return timeline.median_ms(timeline.device_s(tl, "local_ba") for _, tl in timeline.kept(ctx.window))
