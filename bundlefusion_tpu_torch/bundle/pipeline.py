"""The online BundleFusion pipeline: chunks -> keyframes -> global BA -> TSDF
(port of ``bundlefusion_tpu.bundle.pipeline``).

Steady-state design rule, as in the JAX package: between ``push_frame`` and
``flush()`` the host never reads device data. All per-chunk control flow —
chunk/keyframe validity, relocalization, the tracking-lost state machine, the
re-integration work list — lives on the device as masks and ``torch.where``
selects, and per-chunk diagnostics accumulate in a device-side log read once
at ``finalize()``. The host converts frames to the wire format, uploads one
chunk at a time (one pinned, non-blocking copy), and enqueues work.

The ingest stage is the JAX package's: frames convert into FrameStore slabs
(``framewire.frame_to_wire2(out=)``, native C++ when it builds); a chunk's
rows are packed into one flat buffer from a pool of warm pinned buffers in a
3-deep rotation, with depth 12-bit-packed whenever ``depth_max`` allows;
after chunk 0 only the S new rows travel, the overlap frame is reused from
the device (``_prev_tail``). Two module-level single-thread workers take
each chunk in strict FIFO order: the upload worker copies and unpacks it
(``_unpack_wire``) on the pipeline's copy stream, so that on a card the copy
overlaps the previous chunk's compute; the dispatch worker makes the compute
stream wait for that copy (a device-side wait) and runs ``_process_chunk``. Before
chunk c is dispatched, the host waits on a CUDA event recorded at the end of
chunk c-2 (backpressure: a wait on the device, never a readback).
:meth:`BundleFusion.sync` drains the workers and re-raises their exceptions
in chunk order; every public accessor calls it. ``BF_SYNC_INGEST=1`` or
``profile=True`` run both stages on the caller's thread; ``profile=True``
also makes every timed stage wait for the device at its end, and turns the
backpressure off.

Execution, as in the JAX package: the chunk step runs as the stages
``chunk_local``, ``graph_step``, ``global_solve``, ``publish`` and
``plan_fuse``, and every ``gc_every_chunks`` chunks ``gc``, each of which
the JAX package compiles into one XLA program that donates the state's
buffers and is dispatched once per chunk. Here each stage of every chunk,
chunk 0 included, runs through a ``utils/graphs.py`` program: on a card it
runs eagerly and is captured as a CUDA graph at its first call, and is
replayed at every later one. Chunk 0's graph step is a program of its own,
``graph_step_first`` (the JAX package compiles its ``is_first`` graph step
separately); chunk 0's ``chunk_local``, ``publish`` and ``plan_fuse`` are
the programs every later chunk replays. That requires what jit's donation
gives the JAX step, and the port keeps it on the CPU as well: every state
tensor keeps its storage (each stage writes its results into the state in
place, ``copy_into`` where a function builds new arrays), the chunk's
frames are copied into static wire buffers, the chunk index and the frame
ids come from device tensors (:class:`StepInputs`) that the step advances
itself, and both graph steps hand their results to ``plan_fuse`` in the
same buffers (:class:`StepCarry`), so each program's operations are the
same at every chunk. Streaming, revalidation, ``finalize()`` and the
upload's unpack stay eager: host decisions, or work off the step. The
graphs, the state and the compute stream form one executable, kept by
(configuration, device, camera, mesh) in a process-wide cache: a new
pipeline takes an idle one and resets its state in place, as a new JAX
pipeline reuses jit's programs. ``utils/graphs.disable_graphs()`` runs the
step eagerly on a card.

Three places read device state on the host by design, as in the JAX
package: the out-of-core streaming check (every ``streaming_check_every``
chunks until streaming engages, then every chunk), the optional periodic
revalidation after a relocalization (``revalidate_every_chunks``), and
``finalize()``.

Options that change the path: ``integrate_filtered_depth`` filters depth at
the wire (``framewire.bilateral_wire``) instead of in the chunk step; an
integration resolution below the input resolution decimates depth and colour
at the wire for the ring, the FrameStore and K1; a ``mesh``
(``parallel.mesh.make_mesh``) shards the global BA over its shards
(``global_graph.global_solve_sharded``): through the ``global_solve``
program when every shard lives on the pipeline's device (one card), eagerly
when the mesh spans several devices (decided at construction, reported in
``graph_stats``). :class:`FusionState`, :class:`StepState` and the chunk
step's stage functions are also each shard's state, executable and
programs in the multi-sequence pipeline (``parallel/spmd_pipeline.py``).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import functools
import os
import threading
import time
import weakref
from collections import Counter
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config import AppConfig, Config
from ..fusion import blocks, marching_cubes, raycast, streaming, tsdf
from ..geometry import se3
from ..geometry.camera import CameraModel
from ..io import framewire
from ..ops.preprocess import wire_depth_to_m
from ..utils.logging import RunLog
from ..utils import graphs
from ..utils.tensor_ops import copy_into, put_row, row, set_drop
from ..utils.timing import TimingLog
from . import chunk as chunk_mod
from . import global_graph, trajectory


@dataclass
class DeviceCtrl:
    """Device-resident control state (the Bundler state machine as data)."""

    tracking_lost: torch.Tensor  # bool
    consecutive_invalid: torch.Tensor  # int32
    lost_chunks: torch.Tensor  # int32 — cumulative
    reloc_events: torch.Tensor  # int32 — cumulative relocalization count
    last_rel: torch.Tensor  # [4, 4] previous chunk's last local pose


def make_ctrl(device) -> DeviceCtrl:
    def i32():
        return torch.zeros((), dtype=torch.int32, device=device)

    return DeviceCtrl(
        tracking_lost=torch.zeros((), dtype=torch.bool, device=device),
        consecutive_invalid=i32(),
        lost_chunks=i32(),
        reloc_events=i32(),
        last_rel=torch.eye(4, device=device),
    )


# runlog row layout (float32): one row per chunk, read once at finalize()
RUNREC_FIELDS = (
    "chunk_valid", "kf_valid", "reloc", "tracking_lost", "num_keys",
    "filtered_matches", "pairs_valid", "corr_cursor", "alloc_overflow",
    "upd_truncated", "patch_overflow", "reint_frames", "ring_miss",
    "gc_freed_total", "blocks_touched", "active_blocks", "lost_chunks",
)
RUNREC_WIDTH = len(RUNREC_FIELDS)


@dataclass
class StepInputs:
    """The chunk step's per-chunk inputs, as device tensors: the JAX step
    takes them as device arrays, so that one compiled program serves every
    chunk, and here one captured graph does. A pipeline keeps one, which
    :func:`advance_step` moves to the next chunk on the device at the end of
    each chunk's step."""

    chunk: torch.Tensor  # int32 0-d: the chunk index c, also its keyframe slot
    new_ids: torch.Tensor  # [cf] int64: the chunk's frames c*S .. c*S + S
    new_valid: torch.Tensor  # [cf] bool: rows to integrate (after chunk 0 not the overlap row)
    exclude_from: torch.Tensor  # int32 0-d: the re-integration plan skips frames from here on


def step_inputs(c: int, submap_size: int, chunk_frames: int, device) -> StepInputs:
    """Chunk ``c``'s inputs, made on the device (fills, no host copy)."""
    lo = 0 if c == 0 else 1  # after chunk 0 the overlap frame is already integrated
    ar = torch.arange(chunk_frames, device=device)
    return StepInputs(
        chunk=torch.full((), c, dtype=torch.int32, device=device),
        new_ids=ar + c * submap_size,
        new_valid=ar >= lo,
        exclude_from=torch.full((), c * submap_size + lo, dtype=torch.int32, device=device),
    )


def advance_step(step: StepInputs, submap_size: int) -> None:
    """Move ``step`` to the next chunk in place, on the device."""
    step.chunk.add_(1)
    step.new_ids.add_(submap_size)
    step.new_valid.fill_(True)
    step.new_valid[:1].fill_(False)  # (an item assignment would copy a host scalar)
    torch.add(step.chunk * submap_size, 1, out=step.exclude_from)


@dataclass
class StepCarry:
    """The graph step's results that ``plan_fuse`` reads, in fixed buffers:
    chunk 0's graph step (a program of its own) and every later one write
    the same tensors, so one ``plan_fuse`` program serves every chunk."""

    integrate_mask: torch.Tensor  # bool 0-d: integrate the chunk's new frames
    stats_in: torch.Tensor  # [9] f32: the graph step's part of the runlog row


def make_carry(device) -> StepCarry:
    return StepCarry(torch.zeros((), dtype=torch.bool, device=device), torch.zeros(9, device=device))


def _graph_step(st: "FusionState", step: StepInputs, res: chunk_mod.ChunkResult, cache_cam: CameraModel, cfg,
                is_first: bool, carry: StepCarry) -> None:
    """Stages ``graph_step_first`` (chunk 0) and ``graph_step``: all
    keyframe-graph control flow of one chunk: keyframe pose init (chained
    from the previous keyframe), ``add_keyframe``, global matching,
    relocalization, and the tracking-lost state machine. Updates the graph,
    the control state and the per-chunk stores of ``st`` in place (the JAX
    step donates them), and writes (integrate_mask, stats_in) into
    ``carry``."""
    chunk_valid = res.chunk_valid
    k = step.chunk  # one keyframe per chunk
    graph, ctrl = st.graph, st.ctrl
    dev = st.anchor.device
    if is_first:
        kf_valid = chunk_valid
        global_graph.add_keyframe(graph, k, res.keyframe_keys, res.keyframe_cache, st.anchor, kf_valid & chunk_valid)
        reloc = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        prev = k - 1
        chain = row(graph.valid, prev) & chunk_valid & ~ctrl.tracking_lost
        init_pose = torch.where(chain, row(graph.poses, prev) @ ctrl.last_rel, st.anchor)
        global_graph.add_keyframe(graph, k, res.keyframe_keys, res.keyframe_cache, init_pose, chain & chunk_valid)
        # loop closure and relocalization are ONE mechanism: match against
        # all previous keyframes (an invalid chunk's keys are all masked)
        mres = global_graph.global_match(graph, k, cache_cam, cfg)
        reloc = mres.any_valid & chunk_valid & ~chain
        # index with a 1-element tensor: a 0-d index would be read by the host
        best = mres.best_prev.reshape(1)
        pose_r = (graph.poses[best] @ se3.mat_inverse(mres.transforms[best]))[0]
        put_row(graph.poses, k, torch.where(reloc, pose_r, row(graph.poses, k)))
        put_row(graph.valid, k, (chain & chunk_valid) | reloc)
        kf_valid = chain | reloc

    ok = chunk_valid & kf_valid
    consec = torch.where(ok, 0, ctrl.consecutive_invalid + 1).to(torch.int32)
    lost = torch.where(ok, False, torch.where(consec >= cfg.max_invalid_chunks_lost, True, ctrl.tracking_lost))
    lost_chunks = (ctrl.lost_chunks + (~ok & (lost | ~chunk_valid)).to(torch.int32)).to(torch.int32)
    copy_into(ctrl, DeviceCtrl(
        tracking_lost=lost,
        consecutive_invalid=consec,
        lost_chunks=lost_chunks,
        reloc_events=(ctrl.reloc_events + reloc.to(torch.int32)).to(torch.int32),
        last_rel=res.local_traj[-1],
    ))
    put_row(st.local_trajs, k, res.local_traj)
    put_row(st.chunk_valid, k, chunk_valid)
    f32 = torch.float32
    stats_in = torch.stack(
        [
            chunk_valid.to(f32), kf_valid.to(f32), reloc.to(f32), lost.to(f32),
            torch.sum(res.num_keys).to(f32), torch.sum(res.num_matches).to(f32),
            torch.sum(res.pair_valid).to(f32), graph.corr_cursor.to(f32), lost_chunks.to(f32),
        ]
    )
    copy_into(carry, StepCarry(ok, stats_in))


def _publish_all(st: "FusionState", submap_size: int, chunk_frames: int) -> None:
    """Complete trajectory = keyframe pose o local relative pose, for every
    chunk slot, written into ``st.traj`` in place (the JAX step donates the
    trajectory). Overlap frames appear in two chunk slots (last of c, first
    of c+1); as in the reference's scatter, the later slot wins, and a
    second pass re-writes the valid entries only so an invalid neighbour
    never clobbers a valid pose. Each write below has unique ids (columns
    1..S of all chunks first, then column 0), which makes "later wins"
    explicit. Each write builds new [F, ...] arrays (``set_drop``: masked
    rows need a scratch row), copied into the trajectory at the end."""
    local_trajs, kf_poses = st.local_trajs, st.graph.poses
    c_pub = min(local_trajs.shape[0], kf_poses.shape[0])
    dev = kf_poses.device
    world = torch.einsum("cij,csjk->csik", kf_poses[:c_pub], local_trajs[:c_pub])
    valid = (st.chunk_valid[:c_pub] & st.graph.valid[:c_pub])[:, None].expand(c_pub, chunk_frames)
    fids = torch.arange(c_pub, device=dev)[:, None] * submap_size + torch.arange(chunk_frames, device=dev)
    traj = st.traj
    for keep in (None, valid):
        for cols in (slice(1, None), slice(0, 1)):
            traj = trajectory.update_optimized(
                traj,
                fids[:, cols].reshape(-1),
                world[:, cols].reshape(-1, 4, 4),
                valid[:, cols].reshape(-1),
                None if keep is None else keep[:, cols].reshape(-1),
            )
    copy_into(st.traj, traj)


@dataclass
class FusionState:
    """One sequence's device state: what the chunk step reads and writes
    (``_graph_step``, ``_publish_all``, ``_plan_and_fuse``, the GC). The
    serial pipeline holds one; the multi-sequence driver one per shard. The
    ring, the per-frame update records and the runlog carry one scratch row
    past the end: masked writes land there instead of being dropped."""

    anchor: torch.Tensor  # [4, 4] world pose of the first keyframe
    graph: global_graph.GlobalGraph
    ctrl: DeviceCtrl
    table: blocks.BlockTable
    traj: trajectory.TrajectoryState
    # frame ring (slot = id % R) at the integration resolution; depth is
    # uint16 mm held in int16 storage (wire_depth_to_m reads it back)
    hist_d16: torch.Tensor  # [R + 1, H, W] int16
    hist_c8: torch.Tensor  # [R + 1, *color_hw, 3] uint8
    ring_frame: torch.Tensor  # [R] int32, the frame in each slot (-1: none)
    # per-frame update masks / key lists recorded at integrate time (exact
    # de-integration; see tsdf.FuseDiag)
    upd_masks: torch.Tensor  # [F + 1, cap] bool
    upd_keys: torch.Tensor  # [F + 1, cap] int32
    local_trajs: torch.Tensor  # [Cmax, S + 1, 4, 4] each chunk's local poses
    chunk_valid: torch.Tensor  # [Cmax] bool
    runlog_rows: torch.Tensor  # [Cmax + 1, RUNREC_WIDTH], read once at finalize
    blocks_updated: torch.Tensor  # f32, measured work counter
    gc_freed_total: torch.Tensor  # f32

    @property
    def history_cap(self) -> int:
        return self.ring_frame.shape[0]


def make_fusion_state(cfg: Config, int_cam: CameraModel, color_hw: tuple[int, int], anchor: np.ndarray,
                      device) -> FusionState:
    """A fresh :class:`FusionState`: the ring holds depth at ``int_cam``'s
    resolution and colour at ``color_hw`` (half of it on the serial
    pipeline's wire, all of it on the multi-sequence driver's v1 wire)."""
    bc, ac = cfg.bundling, cfg.app
    dev = torch.device(device)
    ring_cap = min(bc.max_frames, ac.history_ring_frames)
    if ring_cap < bc.chunk_size:
        raise ValueError(f"history_ring_frames={ac.history_ring_frames} must hold at least one chunk")
    max_chunks = bc.max_frames // bc.submap_size
    cap = ac.blocks_per_frame_cap
    return FusionState(
        anchor=torch.as_tensor(np.asarray(anchor, np.float32), device=dev),
        graph=global_graph.make_graph(bc, bc.cache_height, bc.cache_width, dev),
        ctrl=make_ctrl(dev),
        table=blocks.make_table(ac.block_capacity, dev),
        traj=trajectory.make_trajectory(bc.max_frames, dev),
        hist_d16=torch.zeros((ring_cap + 1, int_cam.height, int_cam.width), dtype=torch.int16, device=dev),
        hist_c8=torch.zeros((ring_cap + 1, *color_hw, 3), dtype=torch.uint8, device=dev),
        ring_frame=torch.full((ring_cap,), -1, dtype=torch.int32, device=dev),
        upd_masks=torch.zeros((bc.max_frames + 1, cap), dtype=torch.bool, device=dev),
        upd_keys=torch.full((bc.max_frames + 1, cap), blocks.INVALID_KEY, dtype=torch.int32, device=dev),
        local_trajs=torch.eye(4, device=dev).repeat(max_chunks, bc.chunk_size, 1, 1),
        chunk_valid=torch.zeros(max_chunks, dtype=torch.bool, device=dev),
        runlog_rows=torch.zeros((max_chunks + 1, RUNREC_WIDTH), device=dev),
        blocks_updated=torch.zeros((), device=dev),
        gc_freed_total=torch.zeros((), device=dev),
    )


def _plan_and_fuse(st: FusionState, cfg: AppConfig, int_cam: CameraModel, step: StepInputs, stats_in, d16_new,
                   c8_new, integrate_mask, budget: int) -> None:
    """All TSDF pose maintenance of one chunk, on the device: ring write of
    the new frames, budgeted re-integration planning, de-integration at stale
    poses, (re-)integration at optimized poses (K1 at ``int_cam``),
    trajectory bookkeeping, and the diagnostics row (row ``step.chunk``).
    Updates ``st`` in place."""
    r_cap = st.history_cap
    new_ids, new_valid = step.new_ids, step.new_valid
    n_new = new_ids.shape[0]

    # 1. ring write (slot = id % R); masked rows go to the scratch row R
    slots_new = torch.where(new_valid, new_ids % r_cap, r_cap)
    st.hist_d16[slots_new] = d16_new  # in place (donated in the JAX step)
    st.hist_c8[slots_new] = c8_new
    st.ring_frame.copy_(set_drop(st.ring_frame, slots_new, new_ids.to(torch.int32)))

    # 2. plan: residency-aware, new frames excluded (they integrate explicitly)
    plan = trajectory.plan_reintegration(
        st.traj, budget, rot_thresh=cfg.reint_rot_thresh, trans_thresh=cfg.reint_trans_thresh,
        exclude_from=step.exclude_from, ring_frame=st.ring_frame,
    )
    frames = torch.cat([new_ids, plan.frames])
    deint = torch.cat([torch.zeros_like(new_valid), plan.deint_mask])
    reint = torch.cat([new_valid & integrate_mask, plan.reint_mask])

    # 3. ring residency: planned frames spilled past the ring are deferred
    slots = frames % r_cap
    resident = st.ring_frame[slots] == frames
    ring_miss = torch.sum((deint | reint) & ~resident)
    deint = deint & resident
    reint = reint & resident

    # 4. fuse: de-integrate at integrated_pose, (re-)integrate at opt_pose
    traj = st.traj
    new_poses = traj.opt_pose[frames]
    recorded = st.upd_masks[frames]
    table, diag = tsdf.fuse_batch(
        st.table, wire_depth_to_m(st.hist_d16[slots]), st.hist_c8[slots],
        traj.integrated_pose[frames], new_poses, deint, reint, recorded, int_cam, cfg,
        upd_keys_rec=st.upd_keys[frames], deint_rows=frames.shape[0] - n_new,
    )
    copy_into(st.table, table)  # the pools were updated in place; the index is copied back
    integrated = set_drop(traj.integrated, frames, False, deint)
    copy_into(traj, dataclasses.replace(
        traj,
        integrated_pose=set_drop(traj.integrated_pose, frames, new_poses, reint),
        integrated=set_drop(integrated, frames, True, reint),
    ))
    blocks_touched = (torch.sum(recorded & deint[:, None]) + torch.sum(diag.upd_mask)).to(torch.float32)
    # in place; rows not re-integrated go to the scratch row F
    reint_ids = torch.where(reint, frames, st.upd_masks.shape[0] - 1)
    st.upd_masks[reint_ids] = diag.upd_mask
    st.upd_keys[reint_ids] = diag.upd_keys
    st.blocks_updated.add_(blocks_touched)

    # 5. diagnostics row (read once at finalize); stats_in[8] carries the
    # cumulative lost-chunk count from the graph step
    f32 = torch.float32
    stats = torch.cat(
        [
            stats_in[:8],
            torch.stack(
                [
                    diag.overflow.to(f32), diag.upd_truncated.to(f32), diag.patch_overflow.to(f32),
                    torch.sum((deint | reint)[n_new:]).to(f32), ring_miss.to(f32),
                    st.gc_freed_total, blocks_touched, st.table.num_active().to(f32), stats_in[8],
                ]
            ),
        ]
    )
    put_row(st.runlog_rows, step.chunk, stats)


def _chunk_local(wire, cam: CameraModel, cache_cam: CameraModel, bc, ac: AppConfig) -> chunk_mod.ChunkResult:
    """Stage ``chunk_local``: the local pipeline on the chunk's wire (depth,
    then luma, or RGB on the multi-sequence driver's v1 wire)."""
    return chunk_mod.process_chunk(
        wire[0], wire[1], cam, cache_cam, bc, sigma_d=ac.depth_sigma_d, sigma_r=ac.depth_sigma_r,
        # with integrate_filtered_depth the wire is already filtered
        filter_depth=ac.depth_filter and not ac.integrate_filtered_depth,
    )


def _plan_fuse_step(st: FusionState, cfg: AppConfig, int_cam: CameraModel, step: StepInputs, carry: StepCarry,
                    d16: torch.Tensor, c8: torch.Tensor, budget: int, submap_size: int) -> None:
    """Stage ``plan_fuse``: :func:`_plan_and_fuse` on the chunk's depth and
    colour at the integration resolution, then the step inputs move to the
    next chunk."""
    _plan_and_fuse(st, cfg, int_cam, step, carry.stats_in, d16, c8, carry.integrate_mask, budget)
    advance_step(step, submap_size)


def _gc(st: FusionState) -> None:
    """Stage ``gc``: drop the blocks whose every voxel weight is zero (the
    index re-sorts in place) and count them in ``gc_freed_total``."""
    table, freed = blocks.garbage_collect(st.table)
    copy_into(st.table, table)
    st.gc_freed_total.add_(freed.to(torch.float32))


@dataclass
class StepState:
    """What the captured chunk step addresses, kept with its graphs in the
    executable cache: the fusion state, the step inputs, the static device
    copies of a chunk's wire (the serial pipeline's: depth, luma, colour,
    then depth and colour at the integration resolution, the first and
    third again when the resolutions are equal; a multi-sequence shard's:
    depth and RGB), and the graph step's carry."""

    fusion: FusionState
    step: StepInputs
    wire: tuple[torch.Tensor, ...]
    carry: StepCarry


def stream_ctx(device: torch.device, stream):
    """``device`` and ``stream`` for the calling thread (in PyTorch both
    belong to each thread); nothing on the CPU."""
    if stream is None:
        return contextlib.nullcontext()
    stack = contextlib.ExitStack()
    stack.enter_context(torch.cuda.device(device))
    stack.enter_context(torch.cuda.stream(stream))
    return stack


def checkout_step(cache: graphs.ExecutableCache, owner, key, device: torch.device, fresh, wire, submap_size: int,
                  chunk_frames: int) -> graphs.Executable:
    """An idle executable of ``key`` from ``cache``, its fusion state reset in
    place to ``fresh()`` and its step inputs to chunk 0's, or a new one
    whose :class:`StepState` holds ``fresh()``, chunk 0's step inputs and
    the static wire buffers ``wire()`` makes. It returns to the cache when
    ``owner`` is garbage-collected (the JAX step's buffers are donated; a
    dropped owner's state is reused). The state lives on the executable's
    stream."""

    def build():
        exe = graphs.Executable(device, None)
        with stream_ctx(device, exe.stream):
            exe.state = StepState(fresh(), step_inputs(0, submap_size, chunk_frames, device), wire(),
                                  make_carry(device))
        return exe

    exe, reused = cache.checkout(owner, key, build)
    if reused:
        with stream_ctx(device, exe.stream):
            copy_into(exe.state.fusion, fresh())
            copy_into(exe.state.step, step_inputs(0, submap_size, chunk_frames, device))
    return exe


def solve_route(mesh, device: torch.device) -> str | None:
    """How a pipeline on ``device`` with ``mesh`` runs its global solve
    outside a graph, or None when the ``global_solve`` program may capture
    it: a mesh whose shards span several devices (or another device than
    the pipeline's) keeps the eager sharded solve; its cross-device copies
    are not captured."""
    devices = set(mesh.devices) if mesh is not None else {device}
    if devices == {device}:
        return None
    if len(devices) > 1:
        return f"eager: the mesh spans {len(devices)} devices"
    return f"eager: the mesh is on {mesh.devices[0]}, the pipeline on {device}"


# The executables of the serial pipeline's chunk step (graphs and the state
# they address) by (configuration, device, camera), process-wide as jit's
# cache is: a fresh pipeline of a configuration takes an idle one.
_EXECUTABLES = graphs.ExecutableCache()


# --- warm host staging pool --------------------------------------------------
# Host buffers for the chunk upload and the FrameStore, pooled at module level
# so that their pages stay resident across pipeline instances: a first write
# to fresh memory page-faults, and pinning is slow. A pipeline checks out a
# 3-deep rotation of upload buffers (pinned when it feeds a card) and returns
# them, with its FrameStore slabs, when it is garbage-collected.
_STAGING_POOL: dict[tuple, list] = {}
_STAGING_DEPTH = 3
_POOL_LOCK = threading.Lock()
# dispatch runahead: chunks staged but not yet dispatched (each pins a
# chunk's device copy)
_MAX_UNDISPATCHED = 4


@dataclass(eq=False)
class _HostBuf:
    """One pooled host buffer: ``flat`` (uint8, pinned when it feeds a card)
    carved into the ``arrays`` of its spec. ``upload`` is the upload that
    last read it, ``copied`` the CUDA event recorded after that copy."""

    flat: torch.Tensor
    arrays: tuple[np.ndarray, ...]
    upload: concurrent.futures.Future | None = None
    copied: object | None = None


def _new_buf(spec, pinned: bool) -> _HostBuf:
    sizes = [int(np.prod(shape)) * dt.itemsize for shape, dt in spec]
    flat = torch.empty(sum(sizes), dtype=torch.uint8, pin_memory=pinned)
    flat.zero_()  # touch every page now, not inside the first timed chunk
    host, arrays, off = flat.numpy(), [], 0
    for (shape, dt), n in zip(spec, sizes):
        arrays.append(host[off : off + n].view(dt).reshape(shape))
        off += n
    return _HostBuf(flat, tuple(arrays))


def _checkin(key, bufs: list[_HostBuf]) -> None:
    with _POOL_LOCK:
        _STAGING_POOL[key].extend(bufs)


def _staging_checkout(owner, spec, n: int = _STAGING_DEPTH, pinned: bool = False) -> list[_HostBuf]:
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


# --- shared ingest workers ----------------------------------------------------
# One upload worker (host->device copy and unpack) feeding one dispatch
# worker (_process_chunk). Each is a single thread, so chunk order is strict
# per pipeline and across pipelines. Created at first use.
@functools.lru_cache(maxsize=None)
def _executor(stage: str) -> concurrent.futures.ThreadPoolExecutor:
    return concurrent.futures.ThreadPoolExecutor(1, thread_name_prefix=f"bf-{stage}")


def _wire_views(flat: np.ndarray, cf: int, h: int, w: int, hi: int, wi: int, pack12: bool) -> list[np.ndarray]:
    """Carve one chunk's wire out of one flat staging buffer: depth (uint16
    [cf, h, w], or 12-bit-packed uint8 triples [cf, h*w/2*3]), luma [cf, h,
    w], half-res colour [cf, h/2, w/2, 3], then depth and half-res colour at
    the integration resolution when (hi, wi) != (h, w)."""
    views, off = [], 0

    def take(shape, dtype):
        nonlocal off
        n = int(np.prod(shape)) * np.dtype(dtype).itemsize
        views.append(flat[off : off + n].view(dtype).reshape(shape))
        off += n

    def take_d(hh, ww):
        take((cf, hh * ww // 2 * 3), np.uint8) if pack12 else take((cf, hh, ww), np.uint16)

    take_d(h, w)
    take((cf, h, w), np.uint8)
    take((cf, h // 2, w // 2, 3), np.uint8)
    if (hi, wi) != (h, w):
        take_d(hi, wi)
        take((cf, hi // 2, wi // 2, 3), np.uint8)
    return views


def _wire_nbytes(cf: int, h: int, w: int, hi: int, wi: int, pack12: bool) -> int:
    db = (h * w // 2 * 3) if pack12 else (h * w * 2)
    n = cf * db + cf * h * w + cf * (h // 2) * (w // 2) * 3
    if (hi, wi) != (h, w):
        dbi = (hi * wi // 2 * 3) if pack12 else (hi * wi * 2)
        n += cf * dbi + cf * (hi // 2) * (wi // 2) * 3
    return n


def _unpack_wire(flat: torch.Tensor, cf: int, h: int, w: int, hi: int, wi: int, pack12: bool):
    """Device-side unpack of a flat chunk buffer (uint8) laid out by
    :func:`_wire_views`: (depth, luma, colour, depth at the integration
    resolution, colour at it), the last two the first and third when the
    resolutions are equal. Depth comes back as int16 holding the uint16 mm
    bits; 12-bit depth unpacks 3 bytes into 2 values."""
    off = 0

    def take_u16(shape):
        nonlocal off
        n = int(np.prod(shape))
        if pack12:
            t = flat[off : off + n // 2 * 3].reshape(*shape[:-1], shape[-1] // 2, 3).to(torch.int16)
            off += n // 2 * 3
            p0 = t[..., 0] | ((t[..., 1] & 0xF) << 8)
            p1 = (t[..., 1] >> 4) | (t[..., 2] << 4)
            return torch.stack([p0, p1], dim=-1).reshape(shape)
        t = flat[off : off + 2 * n].reshape(*shape, 2).to(torch.int32)
        off += 2 * n
        v = t[..., 0] | (t[..., 1] << 8)
        return ((v ^ 0x8000) - 0x8000).to(torch.int16)  # the uint16 bits as int16

    def take_u8(shape):
        nonlocal off
        n = int(np.prod(shape))
        seg = flat[off : off + n].reshape(shape)
        off += n
        return seg

    d16 = take_u16((cf, h, w))
    y8 = take_u8((cf, h, w))
    c8h = take_u8((cf, h // 2, w // 2, 3))
    if (hi, wi) != (h, w):
        return d16, y8, c8h, take_u16((cf, hi, wi)), take_u8((cf, hi // 2, wi // 2, 3))
    return d16, y8, c8h, d16, c8h


class PipelineOutputs(NamedTuple):
    poses: np.ndarray  # [F, 4, 4] final optimized world poses
    valid: np.ndarray  # [F] bool
    num_keyframes: int
    tracking_lost_chunks: int


class BundleFusion:
    """Online globally-consistent RGB-D reconstruction (offline replay driver)."""

    def __init__(
        self,
        cam: CameraModel,
        config: Config | None = None,
        log_path: str | None = None,
        anchor_pose: np.ndarray | None = None,
        mesh=None,
        *,
        device: torch.device | str,
        profile: bool = False,
    ):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        # profile=True waits for the device at the end of every timed stage,
        # so each stage's time is its own (the default lets a chunk's work
        # queue back to back), and runs ingest on the caller's thread
        self.profile = profile
        self.config = config or Config()
        self.config.validate()
        bc = self.config.bundling
        ac = self.config.app
        # mesh: a parallel.mesh.Mesh; when set, the global BA runs sharded
        # over it (parallel/sharded_ba.py)
        self.mesh = mesh
        if mesh is not None:
            from ..parallel import sharded_ba

            if any(d.type != self.device.type for d in mesh.devices):
                raise ValueError(f"the mesh's devices must be {self.device.type} devices like the pipeline's: {mesh!r}")
            sharded_ba.check_rows(6 * bc.max_num_images, mesh)
        self.cam = cam
        if cam.width % bc.cache_width or cam.height % bc.cache_height:
            raise ValueError(
                f"cache resolution {bc.cache_width}x{bc.cache_height} must divide "
                f"the frame resolution {cam.width}x{cam.height}"
            )
        self.cache_cam = cam.scaled(bc.cache_width, bc.cache_height)
        # SIFT and bundling run at the input resolution, the TSDF at the
        # integration resolution; the wire decimates depth and colour by
        # nearest sampling, so the ring and the FrameStore hold exact bytes
        # for de-integration. Only integer ratios are supported.
        if (ac.integration_width, ac.integration_height) == (cam.width, cam.height):
            self.int_cam = cam
        else:
            if cam.width % ac.integration_width or cam.height % ac.integration_height:
                raise ValueError(
                    f"integration resolution {ac.integration_width}x{ac.integration_height} must "
                    f"integer-divide the input resolution {cam.width}x{cam.height}"
                )
            self.int_cam = cam.scaled(ac.integration_width, ac.integration_height)
        self._int_step = (cam.height // self.int_cam.height, cam.width // self.int_cam.width)
        if cam.width % 2 or cam.height % 2 or self.int_cam.width % 2 or self.int_cam.height % 2:
            raise ValueError("frame dimensions must be even (half-res color wire)")
        self.S = bc.submap_size
        self.chunk_frames = bc.chunk_size
        dev = self.device

        self.num_frames = 0
        self.num_keyframes = 0
        self.chunk_count = 0
        self.gn_iters_executed = 0  # host GN iterations (the device counts blocks updated)
        self.anchor = np.eye(4, dtype=np.float32) if anchor_pose is None else anchor_pose
        # 12-bit depth wire whenever the sensor ceiling fits 12 bits of mm
        # (the reference's default 4.0 m does)
        self._pack12 = ac.depth_max * 1000.0 + 1.0 < 4096.0
        self._wire_dims = (cam.height, cam.width, self.int_cam.height, self.int_cam.width, self._pack12)
        # the chunk step's executable: its programs (captured CUDA graphs on
        # a card unless built under graphs.disable_graphs()), its compute
        # stream, and the state they address: the device state (the ring
        # holds half-res colour, the v2 wire; finalize's service rounds log
        # in the runlog's scratch row), the step inputs, the static wire and
        # the graph step's carry. A mesh over several devices keeps its
        # sharded solve out of the graphs (decided here, once).
        self._route_all = graphs.route_for(dev)
        self._graphed = self._route_all == "graph"
        route = solve_route(mesh, dev)
        self._routes = {"global_solve": route} if route else {}
        self._exe = self._checkout_executable()
        self._programs_at_start = self._exe.counters()
        self.state: FusionState = self._exe.state.fusion
        self._step: StepInputs = self._exe.state.step
        self._wire: tuple[torch.Tensor, ...] = self._exe.state.wire
        self._carry: StepCarry = self._exe.state.carry
        self._step_chunk = 0  # the chunk whose inputs self._step holds
        self.max_chunks = bc.max_frames // self.S
        # frame storage for de/re-integration: the host FrameStore holds every
        # frame (wire format); the device ring caches slot = id % R
        self._frame_store: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        # the FrameStore's backing slabs (chunk_frames rows each) from the
        # warm pool; frame_to_wire2 writes straight into the current row
        self._fs_slabs: list[_HostBuf] = []
        self._next_fid = 0
        self._ring_uploads = 0
        # wire rows (d16, y8, c8h, d16 and c8h at the integration resolution)
        # awaiting a full chunk; the overlap frame stays at the head
        self._pending: list[tuple[np.ndarray, ...]] = []
        # chunk 0 (and the first chunk after a resume) uploads all
        # chunk_frames rows, every later chunk the S new ones
        pinned = dev.type == "cuda"
        self._stage_full = _staging_checkout(self, (((_wire_nbytes(self.chunk_frames, *self._wire_dims),), np.uint8),),
                                             1, pinned)[0]
        self._stage = _staging_checkout(self, (((_wire_nbytes(self.S, *self._wire_dims),), np.uint8),),
                                        pinned=pinned)
        self._stage_rot = 0
        self._chunks_staged = 0  # main thread: chunks handed to the upload stage
        self.upload_bytes: list[int] = []  # bytes of each chunk's upload
        self._prev_tail: tuple[torch.Tensor, ...] | None = None  # upload stage only
        self._bp_events: list = []  # backpressure: the end of each of the last chunks
        # host waits of the ingest stage that blocked, by site: "backpressure"
        # (chunk c-2's CUDA event), "staging" (a buffer's previous upload and
        # copy), "runahead" (the dispatch worker _MAX_UNDISPATCHED chunks behind);
        # counted from two threads, under a lock
        self.ingest_waits: Counter[str] = Counter()
        self._waits_lock = threading.Lock()
        self._chunk_futs: list[concurrent.futures.Future] = []  # dispatch futures (sync() drains)
        self._async_ingest = not profile and os.environ.get("BF_SYNC_INGEST", "0") != "1"
        # the stream every chunk's work is enqueued on, from any thread (the
        # executable's: graphs are captured on a stream of their own), and
        # the upload's own stream (copy and unpack overlap the chunk step)
        self._stream = self._exe.stream
        self._copy_stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._finalized = False
        self._reloc_seen = 0  # relocalizations already followed by a revalidation
        # out-of-core streaming: cold blocks live in the host store; the
        # occupancy check reads device state, so it runs every
        # streaming_check_every chunks until streaming engages, then every chunk
        self.block_store = streaming.HostBlockStore(chunk_blocks=ac.streaming_chunk_blocks)
        self._streaming_on = False
        self.timing = TimingLog(dev)
        self.runlog = RunLog(log_path)

    def _checkout_executable(self) -> graphs.Executable:
        """An idle executable of this configuration, device, camera and mesh
        from the process-wide cache (``checkout_step``), or a new one."""
        dev = self.device
        cf, (h, w, hi, wi, _) = self.chunk_frames, self._wire_dims

        def fresh():
            return make_fusion_state(self.config, self.int_cam, (hi // 2, wi // 2), self.anchor, dev)

        def wire():
            out = [torch.zeros((cf, h, w), dtype=torch.int16, device=dev),
                   torch.zeros((cf, h, w), dtype=torch.uint8, device=dev),
                   torch.zeros((cf, h // 2, w // 2, 3), dtype=torch.uint8, device=dev)]
            if (hi, wi) == (h, w):
                return (*out, out[0], out[2])
            return (*out, torch.zeros((cf, hi, wi), dtype=torch.int16, device=dev),
                    torch.zeros((cf, hi // 2, wi // 2, 3), dtype=torch.uint8, device=dev))

        # the mesh is part of the key: its shard count changes the sharded solve's operations
        mesh = None if self.mesh is None else tuple(map(str, self.mesh.devices))
        key = (self.config.to_json(), str(dev), tuple(self.cam), mesh)
        return checkout_step(_EXECUTABLES, self, key, dev, fresh, wire, self.S, cf)

    @property
    def graph_stats(self) -> dict[str, dict]:
        """Per stage of the chunk step (after this pipeline ran it once):
        ``graph`` (captured), ``replays`` by this pipeline, ``captured``
        (by this pipeline), ``capture_s`` and ``route`` ("graph", or why the
        stage runs eagerly)."""
        return self._exe.stats(self._programs_at_start, self._route)

    def _route(self, name: str) -> str:
        return self._routes.get(name, self._route_all)

    # ------------------------------------------------------------------
    # frame input
    # ------------------------------------------------------------------

    def push_frame(self, depth: np.ndarray, color: np.ndarray) -> None:
        """Feed one frame; chunks are processed as soon as complete. Frames
        convert to the wire format on the host (uint16 mm depth, uint8 luma,
        half-res uint8 colour; with ``integrate_filtered_depth`` the depth is
        bilateral-filtered there, so the ring, the FrameStore and every
        device program see the same bytes; with a separate integration
        resolution, depth and colour are also decimated for fusion) and
        upload once per chunk."""
        ac = self.config.app
        cf, h, w = self.chunk_frames, self.cam.height, self.cam.width
        row = self._next_fid % cf
        if row == 0 or not self._fs_slabs:
            # (no slab at row != 0: a pipeline restored from a checkpoint
            # mid-chunk starts partway into a fresh slab)
            self._fs_slabs += _staging_checkout(
                self, (((cf, h, w), np.uint16), ((cf, h, w), np.uint8), ((cf, h // 2, w // 2, 3), np.uint8)), 1
            )
        slab_d, slab_y, slab_c = self._fs_slabs[-1].arrays
        d16, y8, c8h = framewire.frame_to_wire2(depth, color, out=(slab_d[row], slab_y[row], slab_c[row]),
                                                depth_min=ac.depth_min, depth_max=ac.depth_max)
        if ac.integrate_filtered_depth:
            d16 = framewire.bilateral_wire(d16, ac.depth_sigma_d, ac.depth_sigma_r)
        sy, sx = self._int_step
        d16i, c8hi = (d16, c8h) if (sy, sx) == (1, 1) else (d16[::sy, ::sx], c8h[::sy, ::sx])
        self._frame_store[self._next_fid] = (d16i, c8hi)
        self._next_fid += 1
        self._pending.append((d16, y8, c8h, d16i, c8hi))
        self._maybe_process_chunk()

    def push_batch(self, depth: np.ndarray, color: np.ndarray, valid=None) -> None:
        for i in range(depth.shape[0]):
            if valid is None or valid[i]:
                self.push_frame(depth[i], color[i])

    def _device_ctx(self, stream=None):
        """The pipeline's device and ``stream`` (default: the compute
        stream) for the calling thread."""
        return stream_ctx(self.device, self._stream if stream is None else stream)

    def _count_wait(self, site: str) -> None:
        with self._waits_lock:
            self.ingest_waits[site] += 1

    def _wait_event(self, event, site: str) -> None:
        """Wait on the host for a CUDA event (work already enqueued; no data
        comes back), counting the waits that blocked by site."""
        if not event.query():
            self._count_wait(site)
            event.synchronize()

    def _maybe_process_chunk(self) -> None:
        # chunk c consumes frames [c*S, c*S + S]; the overlap frame c*S stays
        # at the head of _pending for the next chunk
        while len(self._pending) >= self.chunk_frames:
            first = self._chunks_staged == 0
            buf = self._stage_full if first else self._stage[self._stage_rot]
            # the rotation came back to this buffer: its last copy must be done
            if buf.upload is not None and not buf.upload.done():
                self._count_wait("staging")
                concurrent.futures.wait([buf.upload])
            if buf.copied is not None:
                self._wait_event(buf.copied, "staging")
            lo = 0 if first else 1  # after chunk 0 the overlap row is on the device
            views = _wire_views(buf.arrays[0], self.chunk_frames - lo, *self._wire_dims)
            for i, r in enumerate(self._pending[lo : self.chunk_frames]):
                for k, (v, x) in enumerate(zip(views, r)):  # depth, luma, colour[, depth, colour]
                    if self._pack12 and k in (0, 3):
                        framewire.pack_depth12(x, out=v[i])
                    else:
                        v[i] = x
            if not first:
                self._stage_rot = (self._stage_rot + 1) % _STAGING_DEPTH
            self._chunks_staged += 1
            self.upload_bytes.append(buf.flat.numel())
            upload = functools.partial(self._upload, buf, first)
            if self._async_ingest:
                buf.upload = _executor("upload").submit(upload)
                self._bound_runahead()
                self._chunk_futs.append(_executor("dispatch").submit(lambda f=buf.upload: self._dispatch(f.result())))
            else:
                self._dispatch(upload())
            self._pending = self._pending[self.S :]

    def _bound_runahead(self) -> None:
        """Drop dispatched chunks from the head of the futures (a failed one
        stays for sync() to raise), and wait while too many chunks are
        staged but not dispatched."""
        while self._chunk_futs and self._chunk_futs[0].done() and self._chunk_futs[0].exception() is None:
            self._chunk_futs.pop(0)
        waiting = [f for f in self._chunk_futs if not f.done()]
        if len(waiting) >= _MAX_UNDISPATCHED:
            self._count_wait("runahead")
            concurrent.futures.wait(waiting[: len(waiting) - _MAX_UNDISPATCHED + 1])

    def _upload(self, buf: _HostBuf, first: bool):
        """The upload stage, on the copy stream: one copy of a staged chunk
        to the device (the buffer's ``copied`` event marks its end on a
        card), then the device unpack. After chunk 0 the overlap row comes
        from the previous chunk's last row. Returns (depth [cf, H, W] int16,
        luma [cf, H, W], colour [cf, H/2, W/2, 3], then depth and colour at
        the integration resolution), and on a card the event that marks the
        unpack's end."""
        with self._device_ctx(self._copy_stream):
            with self.timing.stage("upload", block=self.profile):
                if self._stream is None:
                    flat = buf.flat.clone()  # the buffer is refilled once this returns
                else:
                    flat = buf.flat.to(self.device, non_blocking=True)
                    buf.copied = torch.cuda.Event()
                    buf.copied.record()
            new = _unpack_wire(flat, self.chunk_frames - (0 if first else 1), *self._wire_dims)
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

    def _dispatch(self, uploaded) -> None:
        """The dispatch stage: run the chunk step on an uploaded chunk
        (:meth:`_upload`'s result), once the compute stream has waited for
        its copy."""
        views, ready = uploaded
        with self._device_ctx():
            if ready is not None:
                self._stream.wait_event(ready)
            self._process_chunk(*views)

    # ------------------------------------------------------------------
    # core per-chunk step
    # ------------------------------------------------------------------

    def _process_chunk(self, d_wire: torch.Tensor, y_wire: torch.Tensor, c_wire: torch.Tensor,
                       d_wire_int: torch.Tensor, c_wire_int: torch.Tensor) -> None:
        """One chunk's step. Its stages run as the JAX package's programs
        do, each through the executable's program of its name
        (:meth:`_run`); chunk 0's graph step is the ``graph_step_first``
        program (the JAX package's ``is_first`` program). The stages read
        the chunk only from the static wire and the step inputs, and update
        the state in place."""
        bc = self.config.bundling
        ac = self.config.app
        c = self.chunk_count
        if c >= min(self.max_chunks, bc.max_num_images):
            raise ValueError(f"chunk {c} exceeds the keyframe/chunk capacity")
        first_frame = c * self.S
        st, step, wire, carry = self.state, self._step, self._wire, self._carry
        t_chunk = time.perf_counter()
        # backpressure: the host dispatches at most ~2 chunks ahead of the device
        if len(self._bp_events) >= 2 and not self.profile:
            self._wait_event(self._bp_events.pop(0), "backpressure")
        # the chunk's wire into the static buffers (the last two alias the
        # first and third at one resolution); the step inputs are set from
        # the host only when they do not hold chunk c (a restored pipeline)
        copied: set[int] = set()
        for dst, src in zip(wire, (d_wire, y_wire, c_wire, d_wire_int, c_wire_int)):
            if id(dst) not in copied:
                dst.copy_(src)
                copied.add(id(dst))
        if self._step_chunk != c:
            copy_into(step, step_inputs(c, self.S, self.chunk_frames, self.device))
        first = c == 0

        with self.timing.stage("chunk_local", block=self.profile):
            res = self._run("chunk_local", _chunk_local, wire, self.cam, self.cache_cam, bc, ac)
        self.gn_iters_executed += bc.local_gn_iters * 2  # 2 solve+prune rounds

        with self.timing.stage("graph_step", block=self.profile):
            self._run("graph_step_first" if first else "graph_step", _graph_step, st, step, res, self.cache_cam, bc,
                      first, carry)
        self.num_keyframes = c + 1  # one keyframe per chunk

        if self.num_keyframes > 1:
            with self.timing.stage("global_solve", block=self.profile):
                if self.mesh is None:
                    self._run("global_solve", global_graph.global_solve, st.graph, self.cache_cam, bc)
                else:
                    self._run("global_solve", global_graph.global_solve_sharded, st.graph, self.mesh,
                              self.cache_cam, bc)
            self.gn_iters_executed += bc.global_gn_iters

        with self.timing.stage("publish", block=self.profile):
            self._run("publish", _publish_all, st, self.S, self.chunk_frames)

        self.num_frames = max(self.num_frames, first_frame + self.chunk_frames)
        with self.timing.stage("plan_fuse", block=self.profile):
            self._run("plan_fuse", _plan_fuse_step, st, ac, self.int_cam, step, carry, wire[3], wire[4],
                      ac.max_reintegrations_per_frame * self.S, self.S)
        self._step_chunk = c + 1

        if ac.gc_every_chunks and (c + 1) % ac.gc_every_chunks == 0:
            with self.timing.stage("gc", block=self.profile):
                self._run("gc", _gc, st)

        # out-of-core streaming: evict far blocks, restore near ones
        if ac.streaming_enabled and (
            self._streaming_on or (ac.streaming_check_every and (c + 1) % ac.streaming_check_every == 0)
        ):
            self._streaming_step(c, c)

        # optional mid-run revalidation after a relocalization (by default
        # deferred to finalize(): the check reads a device counter)
        if bc.revalidate_every_chunks and (c + 1) % bc.revalidate_every_chunks == 0:
            reloc = int(self.state.ctrl.reloc_events)
            if reloc > self._reloc_seen:
                self._reloc_seen = reloc
                if self._revalidate_stale():
                    self._post_revalidate_solve()

        if self._stream is not None:
            self._bp_events.append(torch.cuda.Event())
            self._bp_events[-1].record()
        self.timing.record("whole_chunk_step", time.perf_counter() - t_chunk)
        self.chunk_count += 1

    def _run(self, name: str, fn, *args):
        """Stage ``name`` of the chunk step, through the executable's program
        of that name, which on a card captures at its first call and then
        replays (``graphs.Program``) unless this pipeline was built under
        ``graphs.disable_graphs()`` or routes the stage eagerly
        (``graph_stats``' ``route``)."""
        return self._exe.program(name, fn)(*args, graphed=self._graphed and name not in self._routes)

    def _streaming_step(self, k_idx: int, c: int) -> None:
        """Stream near host blocks in, then (past the occupancy watermark)
        far device blocks out, around keyframe ``k_idx``'s position."""
        ac = self.config.app
        active_blocks = int(self.state.table.num_active())
        cam_pos = self.state.graph.poses[k_idx, :3, 3].cpu().numpy()
        n_in = n_out = 0
        with self.timing.stage("streaming", block=self.profile):
            if len(self.block_store):
                table, n_in = streaming.stream_in(
                    self.state.table, self.block_store, cam_pos, ac, free_capacity=ac.block_capacity - active_blocks
                )
                copy_into(self.state.table, table)
                active_blocks += n_in
            # stream-out engages only past the occupancy watermark, so small
            # scenes never pay host traffic
            if active_blocks > ac.streaming_watermark * ac.block_capacity:
                table, n_out = streaming.stream_out(self.state.table, self.block_store, cam_pos, ac)
                copy_into(self.state.table, table)
        if n_in or n_out:
            self._streaming_on = True
            self.runlog.log(chunk=c, stream_in=n_in, stream_out=n_out, host_blocks=len(self.block_store))

    def _revalidate_stale(self, max_per_event: int = 8, max_rounds: int = 8) -> int:
        """Re-match stale invalidated keyframes against the whole valid graph
        and revalidate the ones that link (the relocalization aftermath).
        Returns the number revalidated. Only keyframes whose chunk solved
        locally are candidates. Work per call is bounded at max_rounds x
        max_per_event matches (each reads one validity flag back); longer
        stale chains unwind across calls, since finalize() and the periodic
        hook both re-enter here."""
        bc = self.config.bundling
        chunk_valid_np = self.state.chunk_valid[: self.num_keyframes].cpu().numpy()
        n_re = 0
        # a chunk that links only through a just-revalidated neighbour
        # recovers in a later round (chains unwind one hop per round)
        for _ in range(max_rounds):
            valid_np = self.state.graph.valid[: self.num_keyframes].cpu().numpy()
            stale = np.flatnonzero(~valid_np & chunk_valid_np)
            if stale.size == 0:
                break
            # candidates nearest a valid keyframe first: stale chains unwind
            # from their anchored ends
            valid_idx = np.flatnonzero(valid_np)
            if valid_idx.size:
                prox = np.min(np.abs(stale[:, None] - valid_idx[None, :]), axis=1)
                stale = stale[np.argsort(prox, kind="stable")]
            progressed = 0
            for k in stale[:max_per_event].tolist():
                mres = global_graph.global_match(self.state.graph, k, self.cache_cam, bc, against_all=True)
                if bool(mres.any_valid):
                    j = int(mres.best_prev)
                    # in place, as the graph step writes keyframe slots
                    self.state.graph.poses[k] = self.state.graph.poses[j] @ se3.mat_inverse(mres.transforms[j])
                    self.state.graph.valid[k] = True
                    progressed += 1
            n_re += progressed
            if not progressed:
                break
        return n_re

    def _global_solve(self) -> None:
        """Global BA of the keyframe graph, sharded over the mesh when there is one."""
        bc = self.config.bundling
        if self.mesh is not None:
            global_graph.global_solve_sharded(self.state.graph, self.mesh, self.cache_cam, bc)
        else:
            global_graph.global_solve(self.state.graph, self.cache_cam, bc)

    def _post_revalidate_solve(self) -> None:
        if self.num_keyframes > 1:
            self._global_solve()
        self._publish_trajectory()

    def _publish_trajectory(self) -> None:
        if self.chunk_count == 0 and self.num_keyframes == 0:
            return
        _publish_all(self.state, self.S, self.chunk_frames)

    # ------------------------------------------------------------------
    # finalize: host-store re-integration service
    # ------------------------------------------------------------------

    def _service_reintegration(self, max_rounds: int | None = None) -> int:
        """Drain the re-integration backlog, re-uploading ring-spilled frames
        from the host FrameStore, then running the same plan-and-fuse step as
        the steady state. Host-driven (reads the plan). Returns frames touched."""
        ac = self.config.app
        budget = ac.max_reintegrations_per_frame * self.S
        if budget <= 0 or self.num_frames == 0:
            return 0
        rounds = max_rounds if max_rounds is not None else max(2, self.num_keyframes * 2)
        st = self.state
        r_cap = st.history_cap
        dev = self.device
        cf, h, w = self.chunk_frames, self.int_cam.height, self.int_cam.width
        empty_d = torch.zeros((cf, h, w), dtype=torch.int16, device=dev)
        empty_c = torch.zeros((cf, h // 2, w // 2, 3), dtype=torch.uint8, device=dev)
        # no new frames; the diagnostics go to the runlog's scratch row
        service = StepInputs(
            chunk=torch.full((), self.max_chunks, dtype=torch.int32, device=dev),
            new_ids=torch.zeros(cf, dtype=torch.int64, device=dev),
            new_valid=torch.zeros(cf, dtype=torch.bool, device=dev),
            exclude_from=torch.full((), self.num_frames, dtype=torch.int32, device=dev),
        )
        no_integrate = torch.zeros((), dtype=torch.bool, device=dev)
        total = 0
        for _ in range(rounds):
            plan = trajectory.plan_reintegration(
                st.traj, budget, rot_thresh=ac.reint_rot_thresh, trans_thresh=ac.reint_trans_thresh,
                exclude_from=self.num_frames,
            )
            frames_np = plan.frames.cpu().numpy()
            work = (plan.deint_mask | plan.reint_mask).cpu().numpy()
            if not work.any():
                break
            ring_np = st.ring_frame.cpu().numpy()
            # at most one frame per ring slot per round (plan order = priority)
            chosen: dict[int, int] = {}
            for f in frames_np[work].tolist():
                chosen.setdefault(f % r_cap, f)
            ups = [f for s, f in chosen.items() if ring_np[s] != f]
            if ups:
                sl = torch.as_tensor([f % r_cap for f in ups], device=dev)
                d = np.stack([self._frame_store[f][0] for f in ups]).view(np.int16)
                st.hist_d16[sl] = torch.as_tensor(d, device=dev)
                st.hist_c8[sl] = torch.as_tensor(np.stack([self._frame_store[f][1] for f in ups]), device=dev)
                st.ring_frame[sl] = torch.as_tensor(ups, dtype=torch.int32, device=dev)
                self._ring_uploads += len(ups)
            _plan_and_fuse(st, ac, self.int_cam, service, torch.zeros(9, device=dev), empty_d, empty_c, no_integrate,
                           budget)
            total += len(chosen)
        return total

    def flush(self) -> None:
        """Process tail frames as a final chunk by repeating the last frame to
        fill it. After chunk 0, ``_pending`` starts with the overlap frame, so
        >= 2 pending means at least one genuinely new frame."""
        if 2 <= len(self._pending) < self.chunk_frames:
            last = self._pending[-1]
            last_host = self._frame_store[self._next_fid - 1]
            while len(self._pending) < self.chunk_frames:
                self._frame_store[self._next_fid] = last_host
                self._next_fid += 1
                self._pending.append(last)
            self._maybe_process_chunk()
        self.sync()

    def sync(self) -> None:
        """Drain the ingest workers: wait until every staged chunk has been
        uploaded and dispatched (its device work may still be in flight;
        reads of its results wait for it). Pipeline state is coherent on the
        caller's thread only after this returns; every public accessor calls
        it first. Exceptions raised on the workers re-raise here in chunk
        order (an upload's through its chunk's dispatch). The caller's
        current stream then waits for the pipeline's stream."""
        while self._chunk_futs:
            self._chunk_futs.pop(0).result()
        if self._stream is not None:
            torch.cuda.current_stream(self.device).wait_stream(self._stream)

    def finalize(self) -> None:
        """End-of-sequence recovery (idempotent): revalidate stale keyframes
        if a relocalization happened since the last revalidation, re-solve,
        then drain the re-integration backlog including ring-spilled frames,
        and emit the runlog. The first device reads of a default run happen
        here."""
        if self._finalized:
            return
        self.sync()
        self._finalized = True
        self._bp_events.clear()
        with self._device_ctx():  # in stream order with the chunk step
            if self.num_keyframes > 1 and int(self.state.ctrl.reloc_events) > self._reloc_seen:
                # each call is bounded; loop until no progress so long stale
                # chains still unwind
                while self._revalidate_stale():
                    self._post_revalidate_solve()
            self._service_reintegration()
            self._emit_runlog()
        self.sync()

    def _emit_runlog(self) -> None:
        rows = self.state.runlog_rows[: self.chunk_count].cpu().numpy()
        ints = ("num_keys", "filtered_matches", "pairs_valid", "corr_cursor", "alloc_overflow",
                "upd_truncated", "patch_overflow", "reint_frames", "ring_miss", "blocks_touched",
                "active_blocks", "lost_chunks", "gc_freed_total")
        for c in range(rows.shape[0]):
            rec = {k: float(v) for k, v in zip(RUNREC_FIELDS, rows[c])}
            for k in ints:
                rec[k] = int(rec[k])
            for k in ("chunk_valid", "kf_valid", "reloc", "tracking_lost"):
                rec[k] = bool(rec[k])
            self.runlog.log(chunk=c, **rec)
        if self._ring_uploads:
            self.runlog.log(ring_uploads=self._ring_uploads)

    # ------------------------------------------------------------------
    # outputs
    # ------------------------------------------------------------------

    @property
    def tracking_lost(self) -> bool:
        self.sync()
        return bool(self.state.ctrl.tracking_lost)

    @property
    def lost_chunks(self) -> int:
        self.sync()
        return int(self.state.ctrl.lost_chunks)

    def current_poses(self) -> tuple[np.ndarray, np.ndarray]:
        self.sync()
        n = self.num_frames
        return self.state.traj.opt_pose[:n].cpu().numpy(), self.state.traj.opt_valid[:n].cpu().numpy()

    def extract_mesh(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Mesh the whole scene: the device table, then the host store's cold
        blocks paged through scratch tables batch by batch (the store is not
        disturbed). Blocks meshed in different batches can leave hairline
        cracks at shared faces, as the reference's chunked meshing does.
        Returns (vertices [V, 3], colours [V, 3], faces [F, 3])."""
        self.sync()
        ac = self.config.app
        parts = [marching_cubes.extract_mesh(self.state.table, ac)]
        batch = 2048
        for keys, sdf, wgt, col in self.block_store.snapshot_batches(batch):
            # a key stored twice keeps its last copy, as the JAX package's
            # in-order scatter does
            last = streaming.last_of_each(keys)
            keys, sdf, wgt, col = keys[last], sdf[last], wgt[last], col[last]
            t = blocks.make_table(batch, self.device)
            keys_t = torch.as_tensor(keys, device=self.device)
            t, _ = blocks.allocate(t, keys_t)
            slots, _ = blocks.lookup(t, keys_t)
            s = slots.long()
            t.sdf[s] = torch.as_tensor(sdf, device=self.device)
            t.weight[s] = torch.as_tensor(wgt, device=self.device)
            t.color[s] = torch.as_tensor(col, device=self.device)
            parts.append(marching_cubes.extract_mesh(t, ac))
        if len(parts) == 1:
            return parts[0]
        offs = np.cumsum([0] + [len(v) for v, _, _ in parts[:-1]])
        return (
            np.concatenate([v for v, _, _ in parts]),
            np.concatenate([c for _, c, _ in parts]),
            np.concatenate([f + o for (_, _, f), o in zip(parts, offs)]).astype(np.int32),
        )

    def render_preview(self, pose: np.ndarray, width: int = 0, height: int = 0) -> np.ndarray:
        """Shaded raycast [H, W, 3] of the TSDF from ``pose`` (camera-to-world)
        at the configured raycast resolution, or ``width`` x ``height``.
        Sets ``splat_truncated``: tile coverage the bounded splat window
        dropped (nonzero means near-camera blocks may be missing)."""
        self.sync()
        ac = self.config.app
        cam = self.cam.scaled(width, height) if width else self.cam.scaled(ac.raycast_width, ac.raycast_height)
        pose_t = torch.as_tensor(np.asarray(pose, np.float32), device=self.device)
        res = raycast.raycast(self.state.table, pose_t, cam, ac)
        self.splat_truncated = int(res.splat_truncated)
        return raycast.shade_preview(res).cpu().numpy()

    def outputs(self) -> PipelineOutputs:
        self.finalize()
        poses, valid = self.current_poses()
        return PipelineOutputs(
            poses=poses, valid=valid, num_keyframes=self.num_keyframes,
            tracking_lost_chunks=int(self.state.ctrl.lost_chunks),
        )


def run_sequence(replayer, config: Config | None = None, anchor_pose: np.ndarray | None = None,
                 log_path: str | None = None, *, device: torch.device | str):
    """Replay a sequence through the pipeline: ``replayer`` yields batches
    with ``depth``, ``color`` and ``valid`` and has a ``camera``."""
    bf = BundleFusion(replayer.camera, config, log_path=log_path, anchor_pose=anchor_pose, device=device)
    for batch in replayer:
        bf.push_batch(batch.depth, batch.color, batch.valid)
    bf.flush()
    bf.finalize()
    return bf, bf.outputs()
