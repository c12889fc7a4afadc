"""The chunk step: one sequence's device state, the stages that update it
and the executable that runs them, for both drivers (the serial pipeline,
``bundle/pipeline.py``, and each shard of the multi-sequence one,
``parallel/spmd_pipeline.py``).

As in the JAX package, all per-chunk control flow (chunk/keyframe
validity, relocalization, the tracking-lost state machine, the
re-integration work list) lives on the device as masks and ``torch.where``
selects, and the chunk step runs as the stages
``chunk_local``, ``graph_step``, ``global_solve``, ``publish`` and
``plan_fuse``, and every ``gc_every_chunks`` chunks ``gc``, each of which
the JAX package compiles into one XLA program that donates the state's
buffers and is dispatched once per chunk. Here each stage of every chunk,
chunk 0 included, runs through a ``utils/graphs.py`` program: on a card it
runs eagerly and is captured as a CUDA graph at its first call, and is
replayed at every later one. Chunk 0's graph step is a program of its own,
``graph_step_first`` (the JAX package compiles its ``is_first`` graph step
separately), and every later chunk's is the program of its slot tier,
``graph_step@T``: global matching runs over the first T keyframe slots,
the smallest tier that holds the chunk's keyframes
(:func:`graph_step_program`), so its work follows the graph's fill, not
its capacity; every tier is captured at the first steady chunk. Chunk 0's
``chunk_local``, ``publish`` and ``plan_fuse`` are the programs every later
chunk replays. That requires what jit's donation gives the JAX step, and
the port keeps it on the CPU as well: every state tensor keeps its storage
(each stage writes its results into the state in place, ``copy_into``
where a function builds new arrays), the chunk's frames are copied into
static wire buffers, the chunk index and the frame ids come from device
tensors (:class:`StepInputs`) that the step advances itself, and every
graph step hands its results to ``plan_fuse`` in the same buffers
(:class:`StepCarry`), so each program's operations are the same at every
chunk. The graphs, the state and the compute stream form one executable,
kept by key in a process-wide cache (:data:`EXECUTABLES`): a new owner
takes an idle one and resets its state in place, as a new JAX pipeline
reuses jit's programs. ``utils/graphs.disable_graphs()`` runs the step
eagerly on a card.

:class:`ChunkStep` owns the stage order; each driver builds one per
executable, with what differs between the drivers set there.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from collections.abc import Callable
from dataclasses import dataclass, field

import numpy as np
import torch

from ..config import AppConfig, Config
from ..fusion import blocks, tsdf
from ..geometry import se3
from ..geometry.camera import CameraModel
from ..ops.preprocess import wire_depth_to_m
from ..utils import graphs, timeline
from ..utils.tensor_ops import copy_into, put_row, row, set_drop
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
# the global solve's dense-term counters (global_graph.dense_counts), int32,
# in a table of their own beside the rows (the JAX package's rows have none);
# 0 without use_dense_global
DENSE_FIELDS = ("dense_pairs_live", "dense_frames_live", "dense_px_valid", "dense_assoc_depth", "dense_assoc_color")
# the global solve's PCG counters, int32, in a table of their own: the live
# rows it solved (6 x (the last free slot + 1)) and the PCG iterations run
# before convergence, summed over its GN iterations; 0 where no global solve ran
PCG_FIELDS = ("pcg_rows", "pcg_iters_run")


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


def reset_step(step: StepInputs) -> None:
    """Set ``step`` to chunk 0's inputs (:func:`step_inputs`) in place."""
    step.chunk.zero_()
    torch.arange(step.new_ids.shape[0], out=step.new_ids)
    step.new_valid.fill_(True)
    step.exclude_from.zero_()


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


def _graph_step(st: "FusionState", step: StepInputs, res: chunk_mod.ChunkResult, cache_cam: CameraModel, cfg,
                is_first: bool, carry: StepCarry, slots: int = 0) -> None:
    """Stages ``graph_step_first`` (chunk 0) and ``graph_step``: all
    keyframe-graph control flow of one chunk: keyframe pose init (chained
    from the previous keyframe), ``add_keyframe``, global matching over the
    first ``slots`` slots (the chunk's tier, :func:`graph_step_program`),
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
        mres = global_graph.global_match(graph, k, cache_cam, cfg, slots=slots)
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


def graph_step_program(c: int, capacity: int) -> tuple[str, int]:
    """Chunk ``c``'s graph-step program and the slots it matches over:
    ``graph_step_first`` (chunk 0 matches nothing) or ``graph_step@T``, T
    the chunk's tier (``global_graph.graph_tier``), chosen on the host from
    the chunk index. Each tier is a program of its own: a captured graph
    has fixed shapes."""
    if c == 0:
        return "graph_step_first", 0
    t = global_graph.graph_tier(c, capacity)
    return f"graph_step@{t}", t


def publish_all(st: "FusionState", submap_size: int, chunk_frames: int) -> None:
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
    (``_graph_step``, :func:`publish_all`, :func:`plan_and_fuse`, the GC).
    The serial pipeline holds one; the multi-sequence driver one per shard.
    The ring, the per-frame update records and the runlog carry one scratch
    row past the end: masked writes land there instead of being dropped."""

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
    stamps: torch.Tensor  # [Cmax + 1, 2 * (len(timeline.SPANS) + dense iters)] int64 device clock, read once
    dense_counts: torch.Tensor  # [Cmax + 1, len(DENSE_FIELDS)] int32, read once at finalize
    pcg_counts: torch.Tensor  # [Cmax + 1, len(PCG_FIELDS)] int32, read once at finalize
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
        anchor=torch.tensor(np.asarray(anchor, np.float32), device=dev),  # a copy: reset writes it
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
        stamps=timeline.make_table(max_chunks + 1, dev, bc.global_gn_iters if bc.use_dense_global else 0),
        dense_counts=torch.zeros((max_chunks + 1, len(DENSE_FIELDS)), dtype=torch.int32, device=dev),
        pcg_counts=torch.zeros((max_chunks + 1, len(PCG_FIELDS)), dtype=torch.int32, device=dev),
        blocks_updated=torch.zeros((), device=dev),
        gc_freed_total=torch.zeros((), device=dev),
    )


def reset_fusion_state(st: FusionState, anchor: np.ndarray) -> None:
    """Set ``st`` to what :func:`make_fusion_state` makes, in place (a reused
    executable's state; nothing of its size is allocated): every tensor to
    zero, then the identity poses, the invalid keys, the slot list and the
    empty ring, and ``anchor``."""
    for t in graphs.tensors(st):
        t.zero_()
    st.anchor.copy_(torch.tensor(np.asarray(anchor, np.float32)))
    for poses in (st.graph.poses, st.ctrl.last_rel, st.traj.integrated_pose, st.traj.opt_pose, st.local_trajs):
        poses.diagonal(dim1=-2, dim2=-1).fill_(1.0)
    for keys in (st.table.keys, st.table.key_of_slot, st.upd_keys):
        keys.fill_(blocks.INVALID_KEY)
    torch.arange(st.table.slot_of.shape[0], out=st.table.slot_of)
    st.ring_frame.fill_(-1)


def plan_and_fuse(st: FusionState, cfg: AppConfig, int_cam: CameraModel, step: StepInputs, stats_in, d16_new,
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


def _chunk_local(wire, cam: CameraModel, cache_cam: CameraModel, bc, ac: AppConfig,
                 stamps: timeline.Stamps | None = None) -> chunk_mod.ChunkResult:
    """Stage ``chunk_local``: the local pipeline on the chunk's wire (depth,
    then luma, or RGB on the multi-sequence driver's v1 wire), its parts
    stamped with ``stamps``."""
    return chunk_mod.process_chunk(
        wire[0], wire[1], cam, cache_cam, bc, sigma_d=ac.depth_sigma_d, sigma_r=ac.depth_sigma_r,
        # with integrate_filtered_depth the wire is already filtered
        filter_depth=ac.depth_filter and not ac.integrate_filtered_depth, stamps=stamps,
    )


def _plan_fuse_step(st: FusionState, cfg: AppConfig, int_cam: CameraModel, step: StepInputs, carry: StepCarry,
                    d16: torch.Tensor, c8: torch.Tensor, budget: int, submap_size: int, fuse) -> None:
    """Stage ``plan_fuse``: ``fuse`` (:func:`plan_and_fuse`) on the chunk's
    depth and colour at the integration resolution, then the step inputs
    move to the next chunk."""
    fuse(st, cfg, int_cam, step, carry.stats_in, d16, c8, carry.integrate_mask, budget)
    advance_step(step, submap_size)


def global_solve_step(st: FusionState, step: StepInputs, cache_cam: CameraModel, cfg,
                      stamps: timeline.Stamps | None = None) -> None:
    """Stage ``global_solve``: the global BA of the keyframe graph
    (``global_graph.global_solve``), in place; its PCG counters written into
    row ``step.chunk`` of ``st.pcg_counts``; with its dense term, the term's
    GN iterations stamped with ``stamps`` and its counters written into row
    ``step.chunk`` of ``st.dense_counts``."""
    _, stats, _ = global_graph.global_solve(st.graph, cache_cam, cfg, stamps=stamps)
    put_row(st.pcg_counts, step.chunk, torch.stack([stats.pcg_rows[-1], stats.pcg_iters_run.sum(dtype=torch.int32)]))
    if stats.dense_counts is not None:
        put_row(st.dense_counts, step.chunk, stats.dense_counts)


def _gc(st: FusionState) -> None:
    """Stage ``gc``: drop the blocks whose every voxel weight is zero (the
    index re-sorts in place) and count them in ``gc_freed_total``."""
    table, freed = blocks.garbage_collect(st.table)
    copy_into(st.table, table)
    st.gc_freed_total.add_(freed.to(torch.float32))


# rows of a stage's begin and end stamps, relative to step.chunk: plan_fuse
# moves the step inputs to the next chunk before its end, gc runs after it
_STAMP_ROWS = {"plan_fuse": (0, -1), "gc": (-1, -1)}


def _stamped(fn, span: str, stamps: timeline.Stamps | None, *args):
    """A stage's program: ``fn(*args)`` between the device stamps of
    ``span``'s begin and end (its first and last nodes in a graph), or
    alone without ``stamps``."""
    if stamps is None:
        return fn(*args)
    first, last = _STAMP_ROWS.get(span, (0, 0))
    stamps.begin(span, first)
    out = fn(*args)
    stamps.end(span, last)
    return out


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


# The chunk step's executables (graphs and the state they address), by key,
# process-wide as jit's cache is: a fresh owner of a key takes an idle one.
# The serial pipeline's key holds its configuration, device, camera and
# mesh; a multi-sequence shard's its configuration, device, camera and the
# v1 wire, whose full-resolution colour ring makes it another step.
EXECUTABLES = graphs.ExecutableCache()


def checkout_step(owner, key, device: torch.device, fresh, anchor: np.ndarray, wire, submap_size: int,
                  chunk_frames: int) -> graphs.Executable:
    """An idle executable of ``key`` from :data:`EXECUTABLES`, its fusion
    state reset in place to what ``fresh()`` makes (with ``anchor``) and its
    step inputs to chunk 0's, or a new one whose :class:`StepState` holds
    ``fresh()``, chunk 0's step inputs and the static wire buffers
    ``wire()`` makes. It returns to the cache when ``owner`` is
    garbage-collected (the JAX step's buffers are donated; a dropped
    owner's state is reused). The state lives on the executable's stream."""

    def build():
        exe = graphs.Executable(device, None)
        with graphs.stream_ctx(device, exe.stream):
            carry = StepCarry(torch.zeros((), dtype=torch.bool, device=device), torch.zeros(9, device=device))
            exe.state = StepState(fresh(), step_inputs(0, submap_size, chunk_frames, device), wire(), carry)
        return exe

    exe, reused = EXECUTABLES.checkout(owner, key, build)
    if reused:
        with graphs.stream_ctx(device, exe.stream):
            reset_fusion_state(exe.state.fusion, anchor)
            reset_step(exe.state.step)
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


@dataclass(eq=False)
class ChunkStep:
    """Chunk ``c``'s stages in order (:meth:`__call__`), each through the
    program of its name in ``exe``, on the state ``exe`` holds. What differs
    between the drivers is set here, once: the device stamps (each stage's
    program stamps the device clock as its first and last node at the row
    of ``step.chunk``; the serial pipeline's, none on a shard), the
    integration camera and the wire buffers ``plan_fuse`` reads, the global
    solve (the stamped step that writes the dense term's counters, the
    solve sharded over a mesh, or a shard's plain solve), and a host span
    around each stage's enqueue."""

    exe: graphs.Executable
    config: Config
    cam: CameraModel  # the wire's: chunk_local's camera
    int_cam: CameraModel  # plan_fuse integrates the last two static wire buffers (depth, colour) at it
    solve: tuple  # the global_solve stage: its function, then its arguments
    route: str  # how the programs run (graphs.route_for at construction): "graph" captures and replays
    routes: dict[str, str] = field(default_factory=dict)  # stages that run otherwise, and why
    stamps: timeline.Stamps | None = None  # each stage's device stamps, or none
    span: Callable = lambda name, c: contextlib.nullcontext()  # a context around stage name's enqueue on the host
    fuse: Callable = plan_and_fuse  # plan_fuse's TSDF maintenance
    at: int = 0  # the chunk whose inputs the step inputs hold

    def __post_init__(self):
        bc = self.config.bundling
        self.cache_cam = self.cam.scaled(bc.cache_width, bc.cache_height)
        self._start = self.exe.counters()

    def stats(self) -> dict[str, dict]:
        """Per program since this step's checkout (``Executable.stats``)."""
        return self.exe.stats(self._start, lambda name: self.routes.get(name, self.route))

    def seek(self, c: int) -> None:
        """Set the step inputs to chunk ``c``'s from the host, where they
        hold another chunk (a pipeline restored from a checkpoint)."""
        if self.at != c:
            bc = self.config.bundling
            copy_into(self.exe.state.step, step_inputs(c, bc.submap_size, bc.chunk_size, self.exe.device))
            self.at = c

    def run(self, name: str, fn, *args):
        """Stage ``name``: ``fn(*args)`` through the executable's program of
        that name (``graphs.Program``: on a card captured at its first call,
        then replayed, unless the stage's route says otherwise), stamped
        (:func:`_stamped`)."""
        program = self.exe.program(name, functools.partial(_stamped, fn, name))
        return program(self.stamps, *args, graphed=self.routes.get(name, self.route) == "graph")

    def _run_graph_step(self, c: int, args: tuple) -> int:
        """Chunk ``c``'s graph step through the program of its tier
        (:func:`graph_step_program`); returns the slot count. On a card, the
        first graphed call also captures every other tier's program without
        running it (``Program.prepare``: a capture runs nothing), so that no
        later chunk that reaches a new tier captures."""
        capacity = self.config.bundling.max_num_images
        graphed = self.route == "graph"

        def program(name, slots):
            return self.exe.program(name, functools.partial(_stamped, functools.partial(_graph_step, slots=slots),
                                                            "graph_step"))

        name, slots = graph_step_program(c, capacity)
        program(name, slots)(self.stamps, *args, graphed=graphed)
        if graphed and slots:
            for t in global_graph.graph_tiers(capacity):
                program(f"graph_step@{t}", t).prepare(self.stamps, *args)
        return slots

    def __call__(self, c: int) -> int:
        """Chunk ``c``'s stages, as the JAX package's programs run them:
        ``chunk_local``, the graph step (``graph_step_first`` at chunk 0,
        then the program of the chunk's slot tier), ``global_solve`` after
        chunk 0, ``publish``, ``plan_fuse`` (which moves the step inputs to
        chunk c + 1) and every ``gc_every_chunks`` chunks ``gc``. The stages
        read the chunk only from the static wire and the step inputs, and
        update the state in place. Returns the graph step's slot count."""
        bc, ac = self.config.bundling, self.config.app
        s = self.exe.state
        st, step, wire, carry = s.fusion, s.step, s.wire, s.carry
        S = bc.submap_size
        with self.span("chunk_local", c):
            res = self.run("chunk_local", _chunk_local, wire, self.cam, self.cache_cam, bc, ac, self.stamps)
        with self.span("graph_step", c):
            slots = self._run_graph_step(c, (st, step, res, self.cache_cam, bc, c == 0, carry))
        if c > 0:
            with self.span("global_solve", c):
                self.run("global_solve", *self.solve)
        with self.span("publish", c):
            self.run("publish", publish_all, st, S, bc.chunk_size)
        with self.span("plan_fuse", c):
            # a fixed new-frame width: after chunk 0 the overlap frame (already integrated) is a masked row
            self.run("plan_fuse", _plan_fuse_step, st, ac, self.int_cam, step, carry, wire[-2], wire[-1],
                     ac.max_reintegrations_per_frame * S, S, self.fuse)
        self.at = c + 1
        if ac.gc_every_chunks and (c + 1) % ac.gc_every_chunks == 0:
            with self.span("gc", c):
                self.run("gc", _gc, st)
        return slots
