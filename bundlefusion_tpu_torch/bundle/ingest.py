"""The serial pipeline's host ingest (the JAX package's ingest stage).

Frames convert into FrameStore slabs (``framewire.frame_to_wire2(out=)``,
native C++ when it builds), with ``integrate_filtered_depth`` filtered
(``framewire.bilateral_wire``) and at an integration resolution below the
input's decimated there. A chunk's rows are packed into one flat buffer
(:func:`_wire_spec`) from a pool of warm pinned buffers in a 3-deep
rotation, with depth 12-bit-packed whenever ``depth_max`` allows; after
chunk 0 only the S new rows travel, the overlap frame is reused from the
device. Two module-level single-thread workers take each chunk in strict
FIFO order: the upload worker copies and unpacks it on the ingest's copy
stream, so that on a card the copy overlaps the previous chunk's compute;
the dispatch worker makes the compute stream wait for that copy (a
device-side wait) and hands the chunk to the driver. Before chunk c is
dispatched, the host waits on a CUDA event recorded at the end of chunk c-2
(backpressure: a wait on the device, never a readback). ``BF_SYNC_INGEST=1``
or ``profile=True`` run both stages on the caller's thread; ``profile=True``
also turns the backpressure off.
"""

from __future__ import annotations

import concurrent.futures
import functools
import os
import threading
import time
import weakref
from collections import Counter
from dataclasses import dataclass

import numpy as np
import torch

from ..config import Config
from ..geometry.camera import CameraModel
from ..io import framewire
from ..utils import graphs, timeline

# Host buffers for the chunk upload and the FrameStore, pooled at module level
# so that their pages stay resident across pipeline instances: a first write
# to fresh memory page-faults, and pinning is slow. An owner checks out a
# 3-deep rotation of upload buffers (pinned when it feeds a card) and returns
# them, with its FrameStore slabs, when it is garbage-collected.
_STAGING_POOL: dict[tuple, list] = {}
STAGING_DEPTH = 3
_POOL_LOCK = threading.Lock()
# dispatch runahead: chunks staged but not yet dispatched (each pins a
# chunk's device copy)
_MAX_UNDISPATCHED = 4


@dataclass(eq=False)
class HostBuf:
    """One pooled host buffer: ``flat`` (uint8, pinned when it feeds a card)
    carved into the ``arrays`` of its spec. ``upload`` is the upload that
    last read it, ``copied`` the CUDA event recorded after that copy."""

    flat: torch.Tensor
    arrays: tuple[np.ndarray, ...]
    upload: concurrent.futures.Future | None = None
    copied: object | None = None


def _segments(flat, spec):
    """(bytes, shape, dtype) of each array of ``spec`` ((shape, dtype), ...),
    one after another in ``flat`` (uint8, numpy or torch)."""
    off = 0
    for shape, dt in spec:
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        yield flat[off : off + n], shape, dt
        off += n


def _carve(flat: np.ndarray, spec) -> list[np.ndarray]:
    """The arrays of ``spec`` in ``flat`` (:func:`_segments`)."""
    return [seg.view(dt).reshape(shape) for seg, shape, dt in _segments(flat, spec)]


def _new_buf(spec, pinned: bool) -> HostBuf:
    flat = torch.empty(sum(int(np.prod(shape)) * dt.itemsize for shape, dt in spec), dtype=torch.uint8,
                       pin_memory=pinned)
    flat.zero_()  # touch every page now, not inside the first timed chunk
    return HostBuf(flat, tuple(_carve(flat.numpy(), spec)))


def _checkin(key, bufs: list[HostBuf]) -> None:
    with _POOL_LOCK:
        _STAGING_POOL[key].extend(bufs)


def staging_checkout(owner, spec, n: int = STAGING_DEPTH, pinned: bool = False) -> list[HostBuf]:
    """Check out ``n`` warm buffers of ``spec`` ((shape, dtype), ...; uint16
    arrays first, so that each starts at an even offset); they return to the
    pool when ``owner`` is garbage-collected."""
    spec = tuple((tuple(shape), np.dtype(dt)) for shape, dt in spec)
    key = (tuple((shape, dt.str) for shape, dt in spec), pinned)
    with _POOL_LOCK:
        free = _STAGING_POOL.setdefault(key, [])
        bufs = [free.pop() for _ in range(min(n, len(free)))]
    bufs += [_new_buf(spec, pinned) for _ in range(n - len(bufs))]
    weakref.finalize(owner, _checkin, key, bufs)
    return bufs


# One upload worker (host->device copy and unpack) feeding one dispatch
# worker (the chunk step). Each is a single thread, so chunk order is strict
# per pipeline and across pipelines. Created at first use.
@functools.lru_cache(maxsize=None)
def _executor(stage: str) -> concurrent.futures.ThreadPoolExecutor:
    return concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix=f"bf-{stage}")


def _wire_spec(cf: int, h: int, w: int, hi: int, wi: int, pack12: bool) -> list[tuple[tuple, type]]:
    """One chunk's wire in one flat buffer: depth (uint16 [cf, h, w], or
    12-bit-packed uint8 triples [cf, h*w/2*3]), luma [cf, h, w], half-res
    colour [cf, h/2, w/2, 3], then depth and half-res colour at the
    integration resolution when (hi, wi) != (h, w)."""
    def depth(hh, ww):
        return ((cf, hh * ww // 2 * 3), np.uint8) if pack12 else ((cf, hh, ww), np.uint16)

    spec = [depth(h, w), ((cf, h, w), np.uint8), ((cf, h // 2, w // 2, 3), np.uint8)]
    if (hi, wi) != (h, w):
        spec += [depth(hi, wi), ((cf, hi // 2, wi // 2, 3), np.uint8)]
    return spec


def _wire_views(flat: np.ndarray, *dims) -> list[np.ndarray]:
    """One chunk's wire (:func:`_wire_spec` of ``dims``) carved out of one flat staging buffer."""
    return _carve(flat, _wire_spec(*dims))


def wire_nbytes(*dims) -> int:
    """The bytes of one chunk's wire (:func:`_wire_spec` of ``dims``)."""
    return sum(int(np.prod(shape)) * np.dtype(dt).itemsize for shape, dt in _wire_spec(*dims))


def _unpack_depth(seg: torch.Tensor, shape: tuple, pack12: bool) -> torch.Tensor:
    """Wire depth (uint8 bytes on the device) as int16 [shape] holding the
    uint16 mm bits; 12-bit depth unpacks 3 bytes into 2 values."""
    if pack12:
        t = seg.reshape(*shape[:-1], shape[-1] // 2, 3).to(torch.int16)
        p0 = t[..., 0] | ((t[..., 1] & 0xF) << 8)
        p1 = (t[..., 1] >> 4) | (t[..., 2] << 4)
        return torch.stack([p0, p1], dim=-1).reshape(shape)
    t = seg.reshape(*shape, 2).to(torch.int32)
    v = t[..., 0] | (t[..., 1] << 8)
    return ((v ^ 0x8000) - 0x8000).to(torch.int16)  # the uint16 bits as int16


def _unpack_wire(flat: torch.Tensor, cf: int, h: int, w: int, hi: int, wi: int, pack12: bool):
    """Device-side unpack of a flat chunk buffer (uint8) laid out by
    :func:`_wire_spec`: (depth, luma, colour, depth at the integration
    resolution, colour at it), the last two the first and third when the
    resolutions are equal; depth as :func:`_unpack_depth` gives it."""
    out = [_unpack_depth(seg, (cf, *((h, w) if k == 0 else (hi, wi))), pack12) if k in (0, 3) else seg.reshape(shape)
           for k, (seg, shape, _) in enumerate(_segments(flat, _wire_spec(cf, h, w, hi, wi, pack12)))]
    return tuple(out) if len(out) == 5 else (*out, out[0], out[2])


class Ingest:
    """The ingest of one serial pipeline. Chunk c goes to the callback
    ``dispatch`` that :meth:`push` and :meth:`flush` take, as
    ``dispatch(depth, luma, colour, depth_int, colour_int, c)`` on the
    compute stream ``stream``; its host spans go to ``host`` (the upload's
    enqueue through ``span(name, c)``), its upload's stamps to ``stamps``."""

    def __init__(self, cam: CameraModel, int_cam: CameraModel, cfg: Config, device: torch.device, stream,
                 stamps: torch.Tensor, host: timeline.HostSpans, span, profile: bool):
        bc, self._ac = cfg.bundling, cfg.app
        self.device, self.S, self.chunk_frames = device, bc.submap_size, bc.chunk_size
        # 12-bit depth wire whenever the sensor ceiling fits 12 bits of mm
        # (the reference's default 4.0 m does)
        self.pack12 = self._ac.depth_max * 1000.0 + 1.0 < 4096.0
        self.wire_dims = (cam.height, cam.width, int_cam.height, int_cam.width, self.pack12)
        self.profile = profile
        self.async_ingest = not profile and os.environ.get("BF_SYNC_INGEST", "0") != "1"
        self._stamps, self._host, self._span = stamps, host, span
        # frame storage for de/re-integration: the host FrameStore holds every
        # frame (wire format); the device ring caches slot = id % R
        self.frame_store: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        # the FrameStore's backing slabs (chunk_frames rows each) from the
        # warm pool; frame_to_wire2 writes straight into the current row
        self.fs_slabs: list[HostBuf] = []
        self.next_fid = 0
        # wire rows (d16, y8, c8h, d16 and c8h at the integration resolution)
        # awaiting a full chunk; the overlap frame stays at the head
        self.pending: list[tuple[np.ndarray, ...]] = []
        # chunk 0 (and the first chunk after a resume) uploads all
        # chunk_frames rows, every later chunk the S new ones
        pinned = device.type == "cuda"
        self.stage_full = staging_checkout(self, (((wire_nbytes(self.chunk_frames, *self.wire_dims),), np.uint8),),
                                           1, pinned)[0]
        self.stage = staging_checkout(self, (((wire_nbytes(self.S, *self.wire_dims),), np.uint8),), pinned=pinned)
        self._stage_rot = 0
        self._chunks_staged = 0  # main thread: chunks handed to the upload stage
        self.upload_bytes: list[int] = []  # bytes of each chunk's upload
        self._prev_tail: tuple[torch.Tensor, ...] | None = None  # upload stage only
        self.bp_events: list = []  # backpressure: the end of each of the last chunks
        # host waits that blocked, by site: "backpressure" (chunk c-2's event),
        # "staging" (a buffer's previous upload and copy), "runahead" (the
        # dispatch worker _MAX_UNDISPATCHED chunks behind); from two threads
        self.waits: Counter[str] = Counter()
        self._waits_lock = threading.Lock()
        self._chunk_futs: list[concurrent.futures.Future] = []  # dispatch futures (sync() drains)
        # the stream every chunk's work is enqueued on, from any thread, and
        # the upload's own stream (copy and unpack overlap the chunk step)
        self._stream = stream
        self._copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None
        if self._copy_stream is not None:
            self._copy_stream.wait_stream(stream)  # the reset state (its stamps) before the first upload
        self._waited = 0.0  # main thread: seconds of the current push spent waiting or dispatching

    def push(self, depth: np.ndarray, color: np.ndarray, dispatch) -> None:
        """Convert one frame to the wire, keep it in the FrameStore, and
        stage every chunk it completes (``BundleFusion.push_frame``)."""
        t0 = time.perf_counter()
        c = self._chunk_of(self.next_fid)
        self._host.put(c, "pushed", t0)
        self._waited = 0.0
        ac = self._ac
        cf, (h, w, hi, wi, _) = self.chunk_frames, self.wire_dims
        with torch.profiler.record_function("ingest"):
            row = self.next_fid % cf
            if row == 0 or not self.fs_slabs:
                # (no slab at row != 0: a pipeline restored from a checkpoint
                # mid-chunk starts partway into a fresh slab)
                self.fs_slabs += staging_checkout(
                    self, (((cf, h, w), np.uint16), ((cf, h, w), np.uint8), ((cf, h // 2, w // 2, 3), np.uint8)), 1
                )
            slab_d, slab_y, slab_c = self.fs_slabs[-1].arrays
            d16, y8, c8h = framewire.frame_to_wire2(depth, color, out=(slab_d[row], slab_y[row], slab_c[row]),
                                                    depth_min=ac.depth_min, depth_max=ac.depth_max)
            if ac.integrate_filtered_depth:
                d16 = framewire.bilateral_wire(d16, ac.depth_sigma_d, ac.depth_sigma_r)
            sy, sx = h // hi, w // wi
            d16i, c8hi = (d16, c8h) if (sy, sx) == (1, 1) else (d16[::sy, ::sx], c8h[::sy, ::sx])
            self.frame_store[self.next_fid] = (d16i, c8hi)
            self.next_fid += 1
            self.pending.append((d16, y8, c8h, d16i, c8hi))
            self._stage_chunks(dispatch)
        self._host.add(c, "ingest_s", time.perf_counter() - t0 - self._waited)

    def flush(self, dispatch) -> None:
        """Stage the tail frames as a final chunk, the last frame repeated
        (after chunk 0 the overlap frame leads ``pending``: >= 2 hold a new one)."""
        if 2 <= len(self.pending) < self.chunk_frames:
            last = self.pending[-1]
            last_host = self.frame_store[self.next_fid - 1]
            while len(self.pending) < self.chunk_frames:
                self.frame_store[self.next_fid] = last_host
                self.next_fid += 1
                self.pending.append(last)
            self._stage_chunks(dispatch, flush=True)

    def sync(self) -> None:
        """Drain the workers (exceptions re-raise in chunk order, an
        upload's through its chunk's dispatch); the caller's current stream
        then waits for the compute stream."""
        while self._chunk_futs:
            self._chunk_futs.pop(0).result()
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)

    def _wait(self, c: int, site: str, wait) -> float:
        """A host wait of the ingest (``wait()``) that blocks: counted by
        site, and chunk ``c``'s span ``wait.<site>``. Returns its seconds."""
        with self._waits_lock:
            self.waits[site] += 1
        t0 = time.perf_counter()
        with torch.profiler.record_function(f"wait.{site}"):
            wait()
        t1 = time.perf_counter()
        self._host.interval(c, f"wait.{site}", t0, t1)
        return t1 - t0

    def _wait_event(self, event, site: str, c: int) -> float:
        """Wait on the host for a CUDA event (work already enqueued; no data
        comes back) if it has not completed (:meth:`_wait`). Returns the
        seconds waited."""
        return 0.0 if event.query() else self._wait(c, site, event.synchronize)

    def _chunk_of(self, fid: int) -> int:
        """The chunk whose new frames hold frame ``fid``: chunk c's are c*S + 1
        .. c*S + S (chunk 0's from frame 0)."""
        return max(0, (fid - 1) // self.S)

    def _stage_chunks(self, dispatch, flush: bool = False) -> None:
        # chunk c consumes frames [c*S, c*S + S]; the overlap frame c*S stays
        # at the head of pending for the next chunk
        while len(self.pending) >= self.chunk_frames:
            first = self._chunks_staged == 0
            c = self._chunk_of(self.next_fid - len(self.pending) + self.chunk_frames - 1)  # of its last frame
            buf = self.stage_full if first else self.stage[self._stage_rot]
            # the rotation came back to this buffer: its last copy must be done
            if buf.upload is not None and not buf.upload.done():
                self._waited += self._wait(c, "staging", functools.partial(concurrent.futures.wait, [buf.upload]))
            if buf.copied is not None:
                self._waited += self._wait_event(buf.copied, "staging", c)
            lo = 0 if first else 1  # after chunk 0 the overlap row is on the device
            views = _wire_views(buf.arrays[0], self.chunk_frames - lo, *self.wire_dims)
            for i, r in enumerate(self.pending[lo : self.chunk_frames]):
                for k, (v, x) in enumerate(zip(views, r)):  # depth, luma, colour[, depth, colour]
                    if self.pack12 and k in (0, 3):
                        framewire.pack_depth12(x, out=v[i])
                    else:
                        v[i] = x
            if not first:
                self._stage_rot = (self._stage_rot + 1) % STAGING_DEPTH
            self._chunks_staged += 1
            self.upload_bytes.append(buf.flat.numel())
            if flush:
                self._host.put(c, "flush", True)
            upload = functools.partial(self._upload, buf, first, c)
            if self.async_ingest:
                buf.upload = _executor("upload").submit(upload)
                self._waited += self._bound_runahead(c)
                self._chunk_futs.append(_executor("dispatch").submit(self._dispatch, buf.upload, c, dispatch))
            else:
                t0 = time.perf_counter()
                self._dispatch(upload(), c, dispatch)
                self._waited += time.perf_counter() - t0
            self.pending = self.pending[self.S :]

    def _bound_runahead(self, c: int) -> float:
        """Drop dispatched chunks from the head of the futures (a failed one
        stays for sync() to raise), and wait while too many chunks are
        staged but not dispatched (chunk ``c`` the last). Returns the
        seconds waited."""
        while self._chunk_futs and self._chunk_futs[0].done() and self._chunk_futs[0].exception() is None:
            self._chunk_futs.pop(0)
        waiting = [f for f in self._chunk_futs if not f.done()]
        if len(waiting) < _MAX_UNDISPATCHED:
            return 0.0
        return self._wait(c, "runahead", functools.partial(concurrent.futures.wait,
                                                           waiting[: len(waiting) - _MAX_UNDISPATCHED + 1]))

    def _upload(self, buf: HostBuf, first: bool, c: int):
        """The upload stage of chunk ``c``, on the copy stream: one copy of a
        staged chunk to the device (stamped on the copy stream; the buffer's
        ``copied`` event marks its end on a card), then the device unpack.
        After chunk 0 the overlap row comes from the previous chunk's last
        row. Returns (depth [cf, H, W] int16, luma [cf, H, W], colour [cf,
        H/2, W/2, 3], then depth and colour at the integration resolution),
        and on a card the event that marks the unpack's end."""
        col = timeline.COLUMN["upload"]
        with graphs.stream_ctx(self.device, self._copy_stream):
            with self._span("upload", c):
                timeline.stamp(self._stamps, col, host_row=c)
                if self._stream is None:
                    flat = buf.flat.clone()  # the buffer is refilled once this returns
                else:
                    flat = buf.flat.to(self.device, non_blocking=True)
                    buf.copied = torch.cuda.Event()
                    buf.copied.record()
                timeline.stamp(self._stamps, col + 1, host_row=c)
            new = _unpack_wire(flat, self.chunk_frames - (0 if first else 1), *self.wire_dims)
            if first:
                full = new
            else:
                same = new[3] is new[0]
                full = tuple(torch.cat([p, n]) for p, n in zip(self._prev_tail, new[: 3 if same else 5]))
                if same:
                    full += (full[0], full[2])
            self._prev_tail = tuple(x[-1:] for x in full)
            if self._copy_stream is None:
                return full, None
            for x in full:
                x.record_stream(self._stream)  # the chunk step reads them on the compute stream
            ready = torch.cuda.Event()
            ready.record()
            return full, ready

    def _dispatch(self, uploaded, c: int, dispatch) -> None:
        """The dispatch stage: once the compute stream has waited for chunk
        ``c``'s copy (:meth:`_upload`'s result; on the dispatch worker its
        future, waited for in the host span ``wait.upload``) and the host
        for the end of chunk c-2 (backpressure: the host dispatches at most
        ~2 chunks ahead of the device), ``dispatch`` runs the chunk step; an
        event marks its end. The chunk's timeline notes whether a profiler
        was recording."""
        if isinstance(uploaded, concurrent.futures.Future):
            with self._host.span(c, "wait.upload"):
                uploaded = uploaded.result()
        self._host.put(c, "profiled", timeline.profiler_active())
        views, ready = uploaded
        with graphs.stream_ctx(self.device, self._stream):
            if ready is not None:
                self._stream.wait_event(ready)
            if len(self.bp_events) >= 2 and not self.profile:
                self._wait_event(self.bp_events.pop(0), "backpressure", c)
            dispatch(*views, c)
            if self._stream is not None:
                self.bp_events.append(torch.cuda.Event())
                self.bp_events[-1].record()
