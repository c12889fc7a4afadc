"""dispatch_ms.live: by the host clock, the median over the window's chunks
of the time from the due time of a chunk's last frame to the return of
``sync()`` after it: the ingest's conversion, staging, upload and the
host's enqueue of the chunk step."""

import statistics


def read(ctx):
    samples = ctx.window.dispatch_s
    return statistics.median(samples) * 1e3 if samples else None
