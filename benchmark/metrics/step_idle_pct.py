"""step_idle_pct: the share of the chunk step's device time in which no
stage ran, unprofiled: over the window's kept chunks whose previous chunk
was not profiled either (``benchmark/timeline.py``), 100 times the sum of
the gaps from the previous chunk's last stage end to the chunk's
``chunk_local`` begin and between the chunk's stages, over the sum of the
times from the previous chunk's last stage end to the chunk's."""

from benchmark import timeline


def read(ctx):
    idle = total = 0.0
    for prev, tl in timeline.kept(ctx.window):
        spans = timeline.stage_spans(tl)
        start = timeline.step_end(prev) if prev is not None and not prev["profiled"] else None
        if start is None or not spans:
            continue
        end = start
        for b, e in spans:
            idle += max(0.0, b - end)
            end = max(end, e)
        total += end - start
    return 100.0 * idle / total if total > 0 else None
