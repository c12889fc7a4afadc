"""The one general traffic generator: a mix's scan rendered from the seed,
and the loop that pushes it through the port.

A mix (``traffic/<mix>.json``) names a scene module (``scene/``), a camera
path in it (``path.kind``: the scene's ``<kind>_poses``, with the rest of
``path`` as its arguments), ``scan_frames`` a scan, ``warm_frames`` of it
for set-up's warm scan, whether to add sensor noise, and the loop: ``closed`` (each frame as soon as the pipeline takes
it; scans back to back) or ``open`` at ``rate_hz`` (each frame at its due
time, t0 + i / rate, whatever the pipeline is doing). Every scan runs the
same rendered frames on a fresh pipeline, which takes the cached executable
of the last. At the deadline the loop stops pushing, flushes and reads the
scan's outputs.

The harness touches the port through ``BundleFusion`` (constructor,
``push_frame``, ``sync``, ``flush``, ``outputs``) and, once a scan's outputs
are read, its counters (``runlog``, ``graph_stats``, ``ingest_waits``) and
the fused model it judges (``state.table``). The card is a ``Card``; the
harness's tests hand the loops a stand-in on the host.
"""

from __future__ import annotations

import gc
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from . import scene as scenes
from .reference import surface
from .scene import noise as sensor_noise
from .trace import SLICE_SPAN

VOXEL_BLOCKS = 2048  # blocks sampled from a scan's model for the judge
RENDER_BATCH = 32  # frames a render call traces: fewer calls, a shorter set-up


class Card:
    """The card a run measures on: its device, a synchronize, timing
    events, its name and its peak of allocated memory."""

    def __init__(self, index: int = 0):
        self.device = torch.device("cuda", index)

    def synchronize(self) -> None:
        torch.cuda.synchronize(self.device)

    def event(self):
        return torch.cuda.Event(enable_timing=True)

    def name(self) -> str:
        return torch.cuda.get_device_name(self.device)

    def peak_bytes(self) -> int:
        return int(torch.cuda.max_memory_allocated(self.device))


@dataclass
class Scan:
    """The frames of one scan, rendered from the seed, and their truth."""

    depth: np.ndarray  # [N, H, W] float32 metres, 0 invalid
    color: np.ndarray  # [N, H, W, 3] float32 in [0, 1]
    poses: np.ndarray  # [N, 4, 4] float32 camera-to-world ground truth
    intrinsics: tuple  # fx, fy, cx, cy
    width: int
    height: int


def scan_poses(mix: dict, seed: int, frames: int | None = None, dtype=torch.float64) -> torch.Tensor:
    """The mix's camera path (``frames`` of it, default ``scan_frames``),
    camera-to-world, computed in ``dtype``."""
    path = dict(mix["path"])
    kind = path.pop("kind")
    return getattr(scenes.load(mix["scene"]), f"{kind}_poses")(frames or mix["scan_frames"], seed, **path, dtype=dtype)


def make_scan(mix: dict, width: int, height: int, seed: int, device, frames: int | None = None) -> Scan:
    """Render the mix's scan (``frames`` of it, default ``scan_frames``) on
    ``device``, with the sensor's noise drawn there from the seed where the
    mix asks for it."""
    scene = scenes.load(mix["scene"])
    poses = scan_poses(mix, seed, frames).to(torch.float32).numpy()
    post = sensor_noise.on_device(seed, device) if mix.get("noise") else None
    depth, color = scene.render(poses, width, height, device, batch=RENDER_BATCH, post=post)
    return Scan(depth, color, poses, scene.intrinsics(width, height), width, height)


def pipeline_factory(scan: Scan, cfg, device):
    """A function that builds a fresh pipeline for the scan."""
    from bundlefusion_tpu_torch.bundle.pipeline import BundleFusion
    from bundlefusion_tpu_torch.geometry.camera import CameraModel

    cam = CameraModel.create(*scan.intrinsics, scan.width, scan.height)
    return lambda: BundleFusion(cam, cfg, anchor_pose=scan.poses[0], device=device)


def weights_at(bf, points: np.ndarray) -> np.ndarray:
    """The pipeline's fused weight in the voxel around each world point
    [M, 3]: 0 where its block is not in the table."""
    from bundlefusion_tpu_torch.fusion import blocks as port_blocks

    table = bf.state.table
    keys = table.key_of_slot.cpu().numpy()
    vox = np.floor(points / bf.config.app.voxel_size).astype(np.int64)
    blk = np.floor_divide(vox, 8)
    local = vox - blk * 8
    c = blk + 512
    inside = np.all((c >= 0) & (c < 1024), axis=-1)
    want = (c[:, 0] | (c[:, 1] << 10) | (c[:, 2] << 20)).astype(keys.dtype)
    live = np.flatnonzero(keys != port_blocks.INVALID_KEY)
    out = np.zeros(len(points), np.float32)
    if live.size == 0:
        return out
    order = np.argsort(keys[live])
    sorted_keys = keys[live][order]
    pos = np.minimum(np.searchsorted(sorted_keys, want), sorted_keys.size - 1)
    found = inside & (sorted_keys[pos] == want)
    if found.any():
        slot = torch.as_tensor(live[order][pos[found]], device=table.weight.device)
        vidx = torch.as_tensor(local[found, 2] * 64 + local[found, 1] * 8 + local[found, 0], device=slot.device)
        out[found] = table.weight[slot, vidx].cpu().numpy()
    return out


def sample_voxels(bf, rng: np.random.Generator, blocks: int = VOXEL_BLOCKS) -> dict:
    """Voxels of the pipeline's fused model for the judge: ``blocks`` of its
    allocated blocks drawn with ``rng``, every voxel of them that holds
    weight: world centres (float64, from the block keys), sdf and weight."""
    from bundlefusion_tpu_torch.fusion import blocks as port_blocks

    table = bf.state.table
    keys = table.key_of_slot.cpu().numpy()
    slots = np.flatnonzero(keys != port_blocks.INVALID_KEY)
    pick = np.sort(rng.choice(slots, size=min(blocks, slots.size), replace=False)) if slots.size else slots
    idx = torch.as_tensor(pick, device=table.sdf.device)
    sdf = table.sdf[idx].cpu().numpy().reshape(-1)
    weight = table.weight[idx].cpu().numpy().reshape(-1)
    k = keys[pick].astype(np.int64)
    coords = np.stack([(k & 1023) - 512, ((k >> 10) & 1023) - 512, ((k >> 20) & 1023) - 512], axis=-1)
    g = np.arange(8) + 0.5
    zz, yy, xx = np.meshgrid(g, g, g, indexing="ij")  # flat voxel index z*64 + y*8 + x
    local = np.stack([xx, yy, zz], axis=-1).reshape(512, 3)
    vs = bf.config.app.voxel_size
    centres = ((coords[:, None, :] * 8 + local[None]) * vs).reshape(-1, 3)
    keep = weight > 0
    return {"centres": centres[keep], "sdf": sdf[keep], "weight": weight[keep]}


def scan_record(bf, out, scan: Scan, frames: int, rng: np.random.Generator, judge: bool) -> dict:
    """What a finished scan leaves for the judge and the readers."""
    rows = [r for r in bf.runlog.records if "chunk_valid" in r]
    rec = {
        "frames": frames,
        "chunks": bf.chunk_count,
        "poses": out.poses,
        "valid": out.valid,
        "dropped": sum(r["upd_truncated"] + r["alloc_overflow"] for r in rows),
        "runlog": rows,
        "corr_overflow": int(bf.state.graph.corr_overflow),
        "ingest_waits": dict(bf.ingest_waits),
        "captured": sorted(k for k, g in bf.graph_stats.items() if g["captured"]),
    }
    if judge:
        v = sample_voxels(bf, rng)
        rec.update(voxel_centres=v["centres"], voxel_sdf=v["sdf"], voxel_weight=v["weight"])
        pts = surface.points(scan.depth[:frames], np.asarray(out.poses[:frames], np.float64), scan.intrinsics, rng)
        rec.update(surface_weight=weights_at(bf, pts))
    return rec


def warm_profiler(card: Card) -> None:
    """Start and stop the slice's profiler once on a few device operations:
    its first start in a process loads and sets up CUPTI, which takes
    seconds."""
    from .trace import profiler

    x = torch.ones(1024, device=card.device)
    with profiler(torch):
        (x * 2).sum()
        card.synchronize()


class Slice:
    """The traced slice: chunks [k0, k1) of the window's first scan under
    ``torch.profiler``. It starts once chunk k0 - 1 is handed to the
    pipeline (after ``sync()``, so that no stage of an earlier chunk is open
    on the host) and stops after chunk k1 - 1's ``sync()`` and a device
    synchronize."""

    def __init__(self, chunks, submap: int, card: Card | None):
        """``card`` is None where no slice is traced."""
        self.k0, self.k1 = chunks
        self.first = self.k0 * submap + 1  # the first new frame of chunk k0
        self.last = self.k1 * submap  # the last frame of chunk k1 - 1
        self.card = card
        self.enabled = card is not None
        self.prof = self.span = None
        self.window_s = None

    def before_push(self, scan_idx: int, i: int, bf) -> None:
        if self.enabled and scan_idx == 0 and i == self.first:
            from .trace import profiler

            bf.sync()
            self.prof = profiler(torch)
            self.prof.__enter__()
            self.span = torch.profiler.record_function(SLICE_SPAN)
            self.span.__enter__()
            self.t0 = time.perf_counter()

    def after_push(self, scan_idx: int, i: int, bf) -> None:
        if self.prof is not None and self.span is not None and scan_idx == 0 and i == self.last:
            bf.sync()
            self.card.synchronize()
            self.window_s = time.perf_counter() - self.t0
            self.span.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.span = None

    def close(self) -> None:
        """Stop a slice that the window's end cut short (its trace is not used)."""
        if self.span is not None:
            self.span.__exit__(None, None, None)
            self.prof.__exit__(None, None, None)
            self.span = self.prof = None

    @property
    def done(self) -> bool:
        return self.window_s is not None


@dataclass
class Window:
    """What a window measured."""

    t0: float
    t_end: float = 0.0
    pushed: int = 0
    scans: list = field(default_factory=list)
    latency_s: list = field(default_factory=list)  # per frame: completion - due (open loop)
    dispatch_s: list = field(default_factory=list)  # per chunk: sync() return - due of its last frame
    lateness_s: list = field(default_factory=list)  # per frame: push start - due (open loop)


def _finish_scan(win: Window, bf, scan: Scan, frames: int, rng, judge: bool) -> None:
    out = bf.outputs()
    win.scans.append(scan_record(bf, out, scan, frames, rng, judge))
    win.pushed += frames


def closed_loop(card: Card, scan: Scan, new_pipeline, deadline: float, rng, sl: Slice, judge: bool = True,
                scans: int | None = None, frames: int | None = None) -> Window:
    """Scans back to back (of ``frames`` frames, default the whole scan),
    each frame pushed as soon as the pipeline takes it, until ``deadline``
    (or ``scans`` scans); then flush and the last scan's outputs."""
    win = Window(time.perf_counter())
    n_frames = min(frames or len(scan.poses), len(scan.poses))
    while time.perf_counter() < deadline and (scans is None or len(win.scans) < scans):
        bf = new_pipeline()
        k = len(win.scans)
        n = 0
        for i in range(n_frames):
            if time.perf_counter() >= deadline:
                break
            sl.before_push(k, i, bf)
            bf.push_frame(scan.depth[i], scan.color[i])
            n += 1
            sl.after_push(k, i, bf)
        bf.flush()
        _finish_scan(win, bf, scan, n, rng, judge)
        bf = None
        gc.collect()  # the pipeline's executable returns to the cache for the next scan
    card.synchronize()
    win.t_end = time.perf_counter()
    return win


def open_loop(card: Card, scan: Scan, new_pipeline, deadline: float, rate_hz: float, submap: int, rng, sl: Slice,
              judge: bool = True) -> Window:
    """Frames pushed at their due times (t0 + i / rate_hz over the window),
    scans back to back, until ``deadline``. After the last frame of each
    chunk the loop calls ``sync()`` and records a timing CUDA event on its
    current stream, which then waits for the pipeline's: the event completes
    with the chunk step that fuses the chunk's frames. Once the window has
    closed, each event's device time, placed on the host clock by a
    reference event recorded and waited for at the window's start, is its
    chunk's completion. (A thread that stamped the host clock as each event
    completed would wait for the interpreter lock first, which one
    ``gc.collect()`` holds for a tenth of a second.)"""
    period = 1.0 / rate_hz
    marks: list = []  # (completion event, due times of the chunk's frames)

    def complete(dues):
        event = card.event()
        event.record()
        marks.append((event, dues))

    ref = card.event()
    ref.record()
    ref.synchronize()
    win = Window(time.perf_counter())
    t_ref = win.t0
    n_frames = len(scan.poses)
    g = 0  # frames pushed in the window, over all scans
    while win.t0 + g * period < deadline:
        bf = new_pipeline()
        k = len(win.scans)
        n, dues = 0, []
        for i in range(n_frames):
            due = win.t0 + g * period
            if due >= deadline:
                break
            wait = due - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            sl.before_push(k, i, bf)
            win.lateness_s.append(time.perf_counter() - due)
            bf.push_frame(scan.depth[i], scan.color[i])
            dues.append(due)
            n += 1
            g += 1
            if i >= submap and i % submap == 0:  # frame i ends chunk i / submap - 1
                bf.sync()
                win.dispatch_s.append(time.perf_counter() - due)
                complete(dues)
                dues = []
            sl.after_push(k, i, bf)
        bf.flush()
        if dues:
            complete(dues)
        _finish_scan(win, bf, scan, n, rng, judge)
        bf = None
        gc.collect()
    card.synchronize()
    win.t_end = time.perf_counter()
    for mark, dues in marks:
        t = t_ref + ref.elapsed_time(mark) / 1e3
        win.latency_s.extend(t - d for d in dues)
    return win
