"""The program's per-chunk timeline as the per-layer readers take it: the
``timeline`` key of each per-chunk runlog record of the window's scans
(``drive.scan_record`` passes the records on), spans as [begin, end] on the
host's ``time.perf_counter`` clock, in seconds; the device's stamps are
placed on that clock by the program.

A reader takes the median (or, for a share, the sum) over the window's kept
chunks: every chunk with a timeline except each scan's chunk 0 (its graph
step is a program of its own), its flush chunk (padded with repeated
frames), and the chunks dispatched while the traced slice's profiler
recorded. Where no chunk has a timeline (a program that records none, the
harness's stand-in pipelines) a reader returns None."""

from __future__ import annotations

import statistics

# the chunk step's stages on the compute stream, as the program stamps them
STAGES = ("chunk_local", "graph_step", "global_solve", "publish", "plan_fuse", "gc")


def kept(window) -> list[tuple[dict | None, dict]]:
    """(the previous chunk's timeline or None, the chunk's timeline) of each
    kept chunk of the window, scan by scan."""
    out = []
    for scan in window.scans:
        prev = None
        for rec in scan["runlog"]:
            tl = rec.get("timeline")
            if tl is not None and rec["chunk"] > 0 and not tl["profiled"] and not tl["flush"]:
                out.append((prev, tl))
            prev = tl
    return out


def median_ms(values) -> float | None:
    """The median of ``values`` (seconds, None left out) in milliseconds."""
    values = [v for v in values if v is not None]
    return statistics.median(values) * 1e3 if values else None


def device_s(tl: dict, span: str) -> float | None:
    """The duration of a stamped device span, or None where it is missing."""
    s = tl["device"].get(span)
    return s[1] - s[0] if s else None


def stage_spans(tl: dict) -> list:
    """The chunk's stamped stages, [begin, end] each, in the order they began."""
    return sorted(tl["device"][s] for s in STAGES if s in tl["device"])


def step_end(tl: dict) -> float | None:
    """The end of the chunk's last stage on the device."""
    spans = stage_spans(tl)
    return max(e for _, e in spans) if spans else None
