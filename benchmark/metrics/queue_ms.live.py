"""queue_ms.live: milliseconds from the entry of a chunk's last frame into
``push_frame`` (host clock) to the begin of its ``chunk_local`` on the
device (the program's stamp, on the host clock): ingest, upload, dispatch
and the wait for the chunk before it; the median over the window's kept
chunks (``benchmark/timeline.py``)."""

from benchmark import timeline


def read(ctx):
    return timeline.median_ms(tl["device"]["chunk_local"][0] - tl["pushed"] for _, tl in timeline.kept(ctx.window)
                              if "chunk_local" in tl["device"] and tl["pushed"] is not None)
