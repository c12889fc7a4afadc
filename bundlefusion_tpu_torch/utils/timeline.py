"""The pipeline's per-chunk timeline: device stamps and host spans on one
clock, the host's ``time.perf_counter``.

Device side: a table of int64 stamps [Cmax + 1, 2 * len(SPANS)] in the
pipeline's state, one row per chunk (the last row is scratch), a begin and
an end column per span of :data:`SPANS`. A stamp is one launch of a
one-thread kernel (``csrc/stamp.cu``) that writes the device's
``%globaltimer`` at the row the device tensor ``step.chunk`` holds (plus a
fixed offset), so a replayed CUDA graph stamps the chunk it runs. Each
stage's program stamps its begin as its first node and its end as its last;
``chunk_local`` also stamps its three parts (:data:`CHILDREN`); the eager
upload stamps its copy on the copy stream, at a row given by the host. On
the CPU the twin writes ``time.perf_counter_ns()``: host and "device" share
one clock there.

Host side: :class:`HostSpans` keeps each chunk's host spans and marks from
the main thread and the ingest workers, in memory. At ``finalize()`` (which
synchronizes anyway) :func:`calibrate` places ``%globaltimer`` on the host
clock once, and :func:`chunk_record` joins both into the runlog record's
``timeline``. Nothing here reads the device between ``push_frame`` and
``flush()``. :func:`idle_account` reads the records back: it splits a run
into the stamped stages and the device's idle time by what the host spans
say held it (``python -m benchmark.idle`` prints it for a cell's window).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from dataclasses import dataclass

import torch

from .. import kernels

# stamped spans, each a (begin, end) pair of columns: the upload's copy (copy
# stream), the chunk step's stages (compute stream) and chunk_local's parts
STAGES = ("chunk_local", "graph_step", "global_solve", "publish", "plan_fuse", "gc")
CHILDREN = ("sift", "pair_match", "local_ba")
SPANS = ("upload", *STAGES, *CHILDREN)
COLUMN = {s: 2 * i for i, s in enumerate(SPANS)}  # begin; end is the next column


@kernels.counted
def stamp(table: torch.Tensor, col: int, row: torch.Tensor | None = None, offset: int = 0, host_row: int = 0) -> None:
    """Write the device clock into ``table`` [rows, cols] int64 at column
    ``col``, row ``row`` (an int32 0-d tensor read on the device) plus
    ``offset``, or ``host_row`` plus ``offset`` without ``row``; a row
    outside the table goes to its last row. CUDA tensors launch the kernel
    (nanoseconds of ``%globaltimer``; counted in ``stamp.launches``); CPU
    tensors write ``time.perf_counter_ns()``."""
    rows, cols = table.shape
    if not table.is_cuda:
        r = (int(row.numpy()) if row is not None else host_row) + offset
        table.numpy()[r if 0 <= r < rows else rows - 1, col] = time.perf_counter_ns()
        return
    kernels.require(table, "table", torch.int64)
    if row is not None:
        kernels.require(row, "row", torch.int32, ())
    err = kernels.library().bf_stamp(table.data_ptr(), None if row is None else row.data_ptr(), host_row, offset,
                                     rows, cols, col, kernels.stream_ptr(table.device))
    kernels.check(err, "stamp")
    kernels.launched(stamp)


def make_table(rows: int, device) -> torch.Tensor:
    """A zeroed stamp table of ``rows`` rows (a stamp of 0 is no stamp)."""
    return torch.zeros((rows, 2 * len(SPANS)), dtype=torch.int64, device=device)


@dataclass
class Stamps:
    """Where a program stamps: the table and the device tensor holding the
    chunk (its row)."""

    table: torch.Tensor
    row: torch.Tensor

    def begin(self, span: str, offset: int = 0) -> None:
        stamp(self.table, COLUMN[span], self.row, offset)

    def end(self, span: str, offset: int = 0) -> None:
        stamp(self.table, COLUMN[span] + 1, self.row, offset)

    @contextlib.contextmanager
    def span(self, name: str):
        self.begin(name)
        yield
        self.end(name)


def calibrate(device: torch.device, tries: int = 32) -> tuple[int, float]:
    """The device clock on the host's: (offset, half-width) in ns, so that a
    stamp s happened at perf_counter_ns() = s + offset, within the
    half-width. Each try takes the host clock just before an eager stamp's
    launch and just after a synchronize; the stamp lies between the two and
    the midpoint is taken; the tightest try wins. Its launches call the
    library alone (no wrapper inside the window), so ``stamp.launches``
    leaves them out. Synchronizes: call it where the device is idle
    (``finalize()``)."""
    buf = torch.zeros((1, 1), dtype=torch.int64, device=device)
    if buf.is_cuda:  # the launch and the wait alone inside the window
        stream = torch.cuda.current_stream(device)
        launch = functools.partial(kernels.library().bf_stamp, buf.data_ptr(), None, 0, 0, 1, 1, 0,
                                   stream.cuda_stream)
        wait = stream.synchronize
    else:
        launch, wait = functools.partial(stamp, buf, 0), (lambda: None)
    best = None
    for _ in range(tries):
        t0 = time.perf_counter_ns()
        err = launch()
        wait()
        t1 = time.perf_counter_ns()
        if buf.is_cuda:
            kernels.check(err, "stamp")
        at = int(buf.cpu()[0, 0])
        if best is None or t1 - t0 < best[1] - best[0]:
            best = (t0, t1, at)
    t0, t1, at = best
    return (t0 + t1) // 2 - at, (t1 - t0) / 2


def profiler_active() -> bool:
    """Whether a ``torch.profiler`` session is recording (on any thread)."""
    return bool(torch.autograd.profiler._is_profiler_enabled)


class HostSpans:
    """Each chunk's host spans ([t0, t1] on ``time.perf_counter``), marks and
    sums, written from the main thread and the ingest workers."""

    def __init__(self):
        self.by_chunk: dict[int, dict] = {}
        self._lock = threading.Lock()

    def put(self, chunk: int, name: str, value) -> None:
        with self._lock:
            self.by_chunk.setdefault(chunk, {})[name] = value

    def add(self, chunk: int, name: str, seconds: float) -> None:
        with self._lock:
            rec = self.by_chunk.setdefault(chunk, {})
            rec[name] = rec.get(name, 0.0) + seconds

    def interval(self, chunk: int, name: str, t0: float, t1: float) -> None:
        """Record [t0, t1] under ``name``, widened over an earlier one."""
        with self._lock:
            rec = self.by_chunk.setdefault(chunk, {})
            old = rec.get(name)
            rec[name] = [min(old[0], t0), max(old[1], t1)] if old else [t0, t1]

    @contextlib.contextmanager
    def span(self, chunk: int, name: str):
        """A host span of ``chunk``, also a profiler span of ``name``."""
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function(name):
                yield
        finally:
            self.interval(chunk, name, t0, time.perf_counter())


HOST_KEYS = ("pushed", "ingest_s", "profiled", "flush")  # marks, sums and flags beside the spans


def chunk_record(stamps_row, host: dict, offset_ns: int, err_ns: float) -> dict:
    """One chunk's ``timeline``: ``device`` spans (the stamped ones, on the
    host clock), ``host`` spans, the marks and flags of :data:`HOST_KEYS`
    and the clock's half-width ``clock_err_s``, all in seconds."""
    device = {}
    for s in SPANS:
        b, e = int(stamps_row[COLUMN[s]]), int(stamps_row[COLUMN[s] + 1])
        if b and e:
            device[s] = [(b + offset_ns) * 1e-9, (e + offset_ns) * 1e-9]
    return {"profiled": bool(host.get("profiled", False)), "flush": bool(host.get("flush", False)),
            "clock_err_s": err_ns * 1e-9, "pushed": host.get("pushed"), "ingest_s": host.get("ingest_s", 0.0),
            "device": device, "host": {k: v for k, v in host.items() if k not in HOST_KEYS}}


# what held the device in a gap before one of a chunk's stages, as the
# chunk's host spans tell: each instant of the gap goes to the first of
# these whose interval holds it, the rest to "other"
GAP_CAUSES = ("staging", "runahead", "ingest", "upload", "backpressure", "wire", "launch")


def _split(gap: tuple[float, float], held: list[tuple[str, list | tuple | None]]) -> dict[str, float]:
    """Seconds of ``gap`` by cause: each instant to the first (cause,
    [t0, t1]) of ``held`` that holds it (None holds nothing), the rest to
    ``other``."""
    pieces, out = [gap], {}
    for cause, span in held:
        lo, hi = span or (0.0, 0.0)
        rest, took = [], 0.0
        for a, b in pieces:
            x, y = max(a, lo), min(b, hi)
            if x < y:
                took += y - x
                rest += [p for p in ((a, x), (y, b)) if p[1] > p[0]]
            else:
                rest.append((a, b))
        out[cause], pieces = out.get(cause, 0.0) + took, rest
    out["other"] = sum(b - a for a, b in pieces)
    return out


def _before_chunk(tl: dict) -> list:
    """What held the device before a chunk's ``chunk_local`` (for
    :func:`_split`): the caller's waits on its staging buffer and on the
    dispatch worker, then the time until the chunk's upload was enqueued
    (the caller still pushing its frames, or waiting for them to be due),
    the upload (its enqueue, its copy, the dispatch worker's wait on them),
    the dispatch worker's backpressure wait and wire copy, and
    ``chunk_local``'s enqueue."""
    host, dev = tl["host"], tl["device"]
    up = [host["upload"], dev.get("upload"), host.get("wait.upload")]
    return [("staging", host.get("wait.staging")), ("runahead", host.get("wait.runahead")),
            ("ingest", (-float("inf"), host["upload"][0])), ("upload", (host["upload"][0], max(s[1] for s in up if s))),
            ("backpressure", host.get("wait.backpressure")), ("wire", host["wire"]), ("launch", host["chunk_local"])]


def idle_account(scans: list[list[dict]], t0: float, t_end: float) -> dict[str, float]:
    """Seconds of a run [t0, t_end] of pipelines one after another, by what
    the device did, from their chunks' timelines (``scans``: each
    pipeline's runlog records in order; records without a timeline are
    skipped): ``stages`` (a stamped stage ran); ``between_scans`` (from
    ``t0`` or a pipeline's last stage to the next one's first: finalize,
    the caller's work, the next pipeline's first chunk of frames);
    ``after_last_scan``; the gap before each later chunk's ``chunk_local``
    by what held it (:data:`GAP_CAUSES`, :func:`_before_chunk`, ``other``);
    the gaps between a chunk's stages as ``launch`` until the host had
    enqueued the next stage, ``between_stages`` after; and ``unaccounted``,
    the rest (stamps a clock error out of order). A profiled chunk's spans
    carry the profiler's cost: read an unprofiled run."""
    acc = dict.fromkeys(("stages", "between_scans", "after_last_scan", "between_stages", *GAP_CAUSES, "other"), 0.0)
    end = t0
    for records in scans:
        first = True
        for rec in records:
            tl = rec.get("timeline")
            if tl is None:
                continue
            for k, s in enumerate(sorted((tl["device"][s], s) for s in STAGES if s in tl["device"])):
                (b, e), name = s
                if k == 0 and first:
                    acc["between_scans"] += max(0.0, b - end)
                elif b > end:
                    held = _before_chunk(tl) if k == 0 else [("launch", (-float("inf"), tl["host"][name][1]))]
                    for cause, sec in _split((end, b), held).items():
                        acc["between_stages" if cause == "other" and k else cause] += sec
                acc["stages"] += e - b
                end = max(end, e)
            first = False
    acc["after_last_scan"] = max(0.0, t_end - end)
    acc["unaccounted"] = (t_end - t0) - sum(acc.values())
    return acc
