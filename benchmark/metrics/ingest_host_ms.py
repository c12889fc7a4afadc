"""ingest_host_ms: host milliseconds a chunk that the caller's thread spends
busy in ``push_frame`` for the chunk's new frames (conversion, staging,
packing; its waits left out), the program's ``ingest_s``; the median over
the window's kept chunks (``benchmark/timeline.py``)."""

from benchmark import timeline


def read(ctx):
    return timeline.median_ms(tl["ingest_s"] for _, tl in timeline.kept(ctx.window))
