"""step_ms.live: device milliseconds from a chunk's ``chunk_local`` begin
to its last stage's end, between the program's stamps: the chunk step
itself, idle gaps between its stages included; the median over the
window's kept chunks (``benchmark/timeline.py``)."""

from benchmark import timeline


def read(ctx):
    return timeline.median_ms(timeline.step_end(tl) - tl["device"]["chunk_local"][0]
                              for _, tl in timeline.kept(ctx.window) if "chunk_local" in tl["device"])
