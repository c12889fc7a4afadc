"""The online BundleFusion pipeline: chunks -> keyframes -> global BA -> TSDF
(port of ``bundlefusion_tpu.bundle.pipeline``).

Steady-state design rule, as in the JAX package: between ``push_frame`` and
``flush()`` the host never reads device data. All per-chunk control flow —
chunk/keyframe validity, relocalization, the tracking-lost state machine, the
re-integration work list — lives on the device as masks and ``torch.where``
selects, and per-chunk diagnostics accumulate in a device-side log read once
at ``finalize()``. The host converts frames to the wire format, uploads one
chunk at a time (one pinned, non-blocking copy), and enqueues work.

Where the JAX package donates buffers to its fused programs, the port
updates them in place: the voxel pools, the frame ring, the per-frame update
records, the keyframe slots and the per-chunk stores (each site says so).

Not ported yet (raise ``NotImplementedError``): out-of-core streaming,
filtered-depth integration, a distinct integration resolution, periodic and
end-of-run revalidation after relocalization, and multi-chip execution.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..fusion import blocks, tsdf
from ..geometry import se3
from ..geometry.camera import CameraModel
from ..io import framewire
from ..ops.preprocess import wire_depth_to_m
from ..utils.logging import RunLog
from ..utils.tensor_ops import set_drop
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


def _graph_step(graph, ctrl: DeviceCtrl, k_idx: int, res: chunk_mod.ChunkResult, local_traj_dev,
                chunk_valid_dev, anchor, cache_cam: CameraModel, cfg, is_first: bool):
    """All keyframe-graph control flow of one chunk: keyframe pose init
    (chained from the previous keyframe), ``add_keyframe``, global matching,
    relocalization, and the tracking-lost state machine. Returns (graph,
    ctrl, integrate_mask, stats_in)."""
    chunk_valid = res.chunk_valid
    dev = anchor.device
    if is_first:
        kf_valid = chunk_valid
        graph = global_graph.add_keyframe(
            graph, k_idx, res.keyframe_keys, res.keyframe_cache, anchor, kf_valid & chunk_valid
        )
        reloc = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        chain = graph.valid[k_idx - 1] & chunk_valid & ~ctrl.tracking_lost
        init_pose = torch.where(chain, graph.poses[k_idx - 1] @ ctrl.last_rel, anchor)
        graph = global_graph.add_keyframe(
            graph, k_idx, res.keyframe_keys, res.keyframe_cache, init_pose, chain & chunk_valid
        )
        # loop closure and relocalization are ONE mechanism: match against
        # all previous keyframes (an invalid chunk's keys are all masked)
        mres = global_graph.global_match(graph, k_idx, cache_cam, cfg)
        graph = mres.graph
        reloc = mres.any_valid & chunk_valid & ~chain
        # index with a 1-element tensor: a 0-d index would be read by the host
        best = mres.best_prev.reshape(1)
        pose_r = (graph.poses[best] @ se3.mat_inverse(mres.transforms[best]))[0]
        # in place: the JAX step donates the graph
        graph.poses[k_idx] = torch.where(reloc, pose_r, graph.poses[k_idx])
        graph.valid[k_idx] = (chain & chunk_valid) | reloc
        kf_valid = chain | reloc

    ok = chunk_valid & kf_valid
    consec = torch.where(ok, 0, ctrl.consecutive_invalid + 1).to(torch.int32)
    lost = torch.where(ok, False, torch.where(consec >= cfg.max_invalid_chunks_lost, True, ctrl.tracking_lost))
    lost_chunks = (ctrl.lost_chunks + (~ok & (lost | ~chunk_valid)).to(torch.int32)).to(torch.int32)
    ctrl = DeviceCtrl(
        tracking_lost=lost,
        consecutive_invalid=consec,
        lost_chunks=lost_chunks,
        reloc_events=(ctrl.reloc_events + reloc.to(torch.int32)).to(torch.int32),
        last_rel=res.local_traj[-1],
    )
    # in place: the per-chunk stores are donated in the JAX step
    local_traj_dev[k_idx] = res.local_traj
    chunk_valid_dev[k_idx] = chunk_valid
    f32 = torch.float32
    stats_in = torch.stack(
        [
            chunk_valid.to(f32), kf_valid.to(f32), reloc.to(f32), lost.to(f32),
            torch.sum(res.num_keys).to(f32), torch.sum(res.num_matches).to(f32),
            torch.sum(res.pair_valid).to(f32), graph.corr_cursor.to(f32), lost_chunks.to(f32),
        ]
    )
    return graph, ctrl, ok, stats_in


def _publish_all(traj, local_trajs, chunk_valid, kf_poses, kf_valid, submap_size: int, chunk_frames: int):
    """Complete trajectory = keyframe pose o local relative pose, for every
    chunk slot. Overlap frames appear in two chunk slots (last of c, first of
    c+1); as in the reference's scatter, the later slot wins, and a second
    pass re-writes the valid entries only so an invalid neighbour never
    clobbers a valid pose. Each write below has unique ids (columns 1..S of
    all chunks first, then column 0), which makes "later wins" explicit.

    The JAX step donates the trajectory; here each write builds new [F, ...]
    arrays (``set_drop``), because masked rows need a scratch row and
    TrajectoryState keeps the reference's shapes. They are small (F x 4 x 4)."""
    c_pub = min(local_trajs.shape[0], kf_poses.shape[0])
    dev = kf_poses.device
    world = torch.einsum("cij,csjk->csik", kf_poses[:c_pub], local_trajs[:c_pub])
    valid = (chunk_valid[:c_pub] & kf_valid[:c_pub])[:, None].expand(c_pub, chunk_frames)
    fids = torch.arange(c_pub, device=dev)[:, None] * submap_size + torch.arange(chunk_frames, device=dev)
    for keep in (None, valid):
        for cols in (slice(1, None), slice(0, 1)):
            traj = trajectory.update_optimized(
                traj,
                fids[:, cols].reshape(-1),
                world[:, cols].reshape(-1, 4, 4),
                valid[:, cols].reshape(-1),
                None if keep is None else keep[:, cols].reshape(-1),
            )
    return traj


def _plan_and_fuse(st: "BundleFusion", chunk_idx: int, stats_in, d16_new, c8_new, new_ids, new_valid,
                   integrate_mask, exclude_from: int, budget: int) -> None:
    """All TSDF pose maintenance of one chunk, on the device: ring write of
    the new frames, budgeted re-integration planning, de-integration at stale
    poses, (re-)integration at optimized poses (K1), trajectory bookkeeping,
    and the diagnostics row. Updates ``st``'s device state in place."""
    cfg = st.config.app
    r_cap = st.history_cap
    n_new = new_ids.shape[0]

    # 1. ring write (slot = id % R); masked rows go to the scratch row R
    slots_new = torch.where(new_valid, new_ids % r_cap, r_cap)
    st._hist_d16[slots_new] = d16_new  # in place (donated in the JAX step)
    st._hist_c8[slots_new] = c8_new
    st._ring_frame = set_drop(st._ring_frame, slots_new, new_ids.to(torch.int32))

    # 2. plan: residency-aware, new frames excluded (they integrate explicitly)
    plan = trajectory.plan_reintegration(
        st.traj, budget, rot_thresh=cfg.reint_rot_thresh, trans_thresh=cfg.reint_trans_thresh,
        exclude_from=exclude_from, ring_frame=st._ring_frame,
    )
    frames = torch.cat([new_ids, plan.frames])
    deint = torch.cat([torch.zeros_like(new_valid), plan.deint_mask])
    reint = torch.cat([new_valid & integrate_mask, plan.reint_mask])

    # 3. ring residency: planned frames spilled past the ring are deferred
    slots = frames % r_cap
    resident = st._ring_frame[slots] == frames
    ring_miss = torch.sum((deint | reint) & ~resident)
    deint = deint & resident
    reint = reint & resident

    # 4. fuse: de-integrate at integrated_pose, (re-)integrate at opt_pose
    traj = st.traj
    new_poses = traj.opt_pose[frames]
    recorded = st._upd_masks[frames]
    st.table, diag = tsdf.fuse_batch(
        st.table, wire_depth_to_m(st._hist_d16[slots]), st._hist_c8[slots],
        traj.integrated_pose[frames], new_poses, deint, reint, recorded, st.int_cam, cfg,
        upd_keys_rec=st._upd_keys[frames], deint_rows=frames.shape[0] - n_new,
    )
    integrated = set_drop(traj.integrated, frames, False, deint)
    st.traj = dataclasses.replace(
        traj,
        integrated_pose=set_drop(traj.integrated_pose, frames, new_poses, reint),
        integrated=set_drop(integrated, frames, True, reint),
    )
    blocks_touched = (torch.sum(recorded & deint[:, None]) + torch.sum(diag.upd_mask)).to(torch.float32)
    # in place; rows not re-integrated go to the scratch row F
    reint_ids = torch.where(reint, frames, st._upd_masks.shape[0] - 1)
    st._upd_masks[reint_ids] = diag.upd_mask
    st._upd_keys[reint_ids] = diag.upd_keys
    st.blocks_updated = st.blocks_updated + blocks_touched

    # 5. diagnostics row (read once at finalize); stats_in[8] carries the
    # cumulative lost-chunk count from the graph step
    f32 = torch.float32
    row = torch.cat(
        [
            stats_in[:8],
            torch.stack(
                [
                    diag.overflow.to(f32), diag.upd_truncated.to(f32), diag.patch_overflow.to(f32),
                    torch.sum((deint | reint)[n_new:]).to(f32), ring_miss.to(f32),
                    st._gc_freed_total, blocks_touched, st.table.num_active().to(f32), stats_in[8],
                ]
            ),
        ]
    )
    st._runlog_dev[chunk_idx] = row  # in place


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
    ):
        self.device = torch.device(device)
        self.config = config or Config()
        self.config.validate()
        bc = self.config.bundling
        ac = self.config.app
        if mesh is not None:
            raise NotImplementedError("multi-chip execution (a mesh) is not ported yet")
        if ac.integrate_filtered_depth:
            raise NotImplementedError("integrate_filtered_depth=True is not ported yet")
        if (ac.integration_width, ac.integration_height) != (cam.width, cam.height):
            raise NotImplementedError(
                "an integration resolution different from the input resolution is not ported yet"
            )
        if bc.revalidate_every_chunks > 0:
            raise NotImplementedError("revalidate_every_chunks > 0 is not ported yet")
        self.cam = cam
        if cam.width % bc.cache_width or cam.height % bc.cache_height:
            raise ValueError(
                f"cache resolution {bc.cache_width}x{bc.cache_height} must divide "
                f"the frame resolution {cam.width}x{cam.height}"
            )
        if cam.width % 2 or cam.height % 2:
            raise ValueError("frame dimensions must be even (half-res color wire)")
        self.cache_cam = cam.scaled(bc.cache_width, bc.cache_height)
        self.int_cam = cam
        self.S = bc.submap_size
        self.chunk_frames = bc.chunk_size
        dev = self.device

        self.table = blocks.make_table(ac.block_capacity, dev)
        self.graph = global_graph.make_graph(bc, bc.cache_height, bc.cache_width, dev)
        self.traj = trajectory.make_trajectory(bc.max_frames, dev)
        self.ctrl = make_ctrl(dev)
        self.num_frames = 0
        self.num_keyframes = 0
        self.chunk_count = 0
        # measured work counters: device-side blocks updated, host GN iterations
        self.blocks_updated = torch.zeros((), device=dev)
        self.gn_iters_executed = 0
        self._gc_freed_total = torch.zeros((), device=dev)
        self.anchor = np.eye(4, dtype=np.float32) if anchor_pose is None else anchor_pose
        self._anchor_dev = torch.as_tensor(np.asarray(self.anchor, np.float32), device=dev)

        # frame storage for de/re-integration: the host FrameStore holds every
        # frame (wire format); the device ring caches slot = id % R. Depth is
        # uint16 mm held in int16 storage (wire_depth_to_m reads it back).
        # The ring and the per-frame records carry one scratch row past the
        # end: masked writes land there instead of being dropped.
        self.history_cap = min(bc.max_frames, ac.history_ring_frames)
        if self.history_cap < bc.chunk_size:
            raise ValueError(
                f"history_ring_frames={ac.history_ring_frames} must hold at least one chunk"
            )
        h, w = cam.height, cam.width
        self._hist_d16 = torch.zeros((self.history_cap + 1, h, w), dtype=torch.int16, device=dev)
        self._hist_c8 = torch.zeros((self.history_cap + 1, h // 2, w // 2, 3), dtype=torch.uint8, device=dev)
        self._ring_frame = torch.full((self.history_cap,), -1, dtype=torch.int32, device=dev)
        self._frame_store: dict[int, tuple[np.ndarray, np.ndarray]] = {}
        self._next_fid = 0
        self._ring_uploads = 0
        # per-frame update masks / key lists recorded at integrate time
        # (exact de-integration; see tsdf.FuseDiag)
        cap = ac.blocks_per_frame_cap
        self._upd_masks = torch.zeros((bc.max_frames + 1, cap), dtype=torch.bool, device=dev)
        self._upd_keys = torch.full((bc.max_frames + 1, cap), blocks.INVALID_KEY, dtype=torch.int32, device=dev)
        self.max_chunks = bc.max_frames // self.S
        self._local_traj_dev = torch.eye(4, device=dev).repeat(self.max_chunks, self.chunk_frames, 1, 1)
        self._chunk_valid_dev = torch.zeros(self.max_chunks, dtype=torch.bool, device=dev)
        # +1 scratch row: finalize's service rounds log there
        self._runlog_dev = torch.zeros((self.max_chunks + 1, RUNREC_WIDTH), device=dev)
        self._pending: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        self._finalized = False
        self.timing = TimingLog(dev)
        self.runlog = RunLog(log_path)

    # ------------------------------------------------------------------
    # frame input
    # ------------------------------------------------------------------

    def push_frame(self, depth: np.ndarray, color: np.ndarray) -> None:
        """Feed one frame; chunks are processed as soon as complete. Frames
        convert to the wire format on the host (uint16 mm depth, uint8 luma,
        half-res uint8 colour) and upload once per chunk."""
        ac = self.config.app
        d16, y8, c8h = framewire.frame_to_wire2(depth, color, depth_min=ac.depth_min, depth_max=ac.depth_max)
        self._frame_store[self._next_fid] = (d16, c8h)
        self._next_fid += 1
        self._pending.append((d16, y8, c8h))
        self._maybe_process_chunk()

    def push_batch(self, depth: np.ndarray, color: np.ndarray, valid=None) -> None:
        for i in range(depth.shape[0]):
            if valid is None or valid[i]:
                self.push_frame(depth[i], color[i])

    def _maybe_process_chunk(self) -> None:
        # chunk c consumes frames [c*S, c*S + S]; the overlap frame c*S stays
        # at the head of _pending for the next chunk
        while len(self._pending) >= self.chunk_frames:
            self._process_chunk(*self._upload(self._pending[: self.chunk_frames]))
            self._pending = self._pending[self.S :]

    def _upload(self, rows: list[tuple[np.ndarray, np.ndarray, np.ndarray]]):
        """Stack one chunk's wire on the host into one (pinned, on a card)
        buffer and send it with one non-blocking copy. Returns device views
        (depth [cf, H, W] int16, luma [cf, H, W] uint8, colour [cf, H/2, W/2, 3])."""
        cf = len(rows)
        h, w = self.cam.height, self.cam.width
        n1, n2, n3 = cf * h * w * 2, cf * h * w, cf * (h // 2) * (w // 2) * 3
        pinned = self.device.type == "cuda"
        flat = torch.empty(n1 + n2 + n3, dtype=torch.uint8, pin_memory=pinned)
        host = flat.numpy()
        host[:n1].view(np.uint16).reshape(cf, h, w)[:] = [r[0] for r in rows]
        host[n1 : n1 + n2].reshape(cf, h, w)[:] = [r[1] for r in rows]
        host[n1 + n2 :].reshape(cf, h // 2, w // 2, 3)[:] = [r[2] for r in rows]
        dev = flat.to(self.device, non_blocking=pinned)
        d16 = dev[:n1].view(torch.int16).view(cf, h, w)
        y8 = dev[n1 : n1 + n2].view(cf, h, w)
        c8 = dev[n1 + n2 :].view(cf, h // 2, w // 2, 3)
        return d16, y8, c8

    # ------------------------------------------------------------------
    # core per-chunk step
    # ------------------------------------------------------------------

    def _process_chunk(self, d_wire: torch.Tensor, y_wire: torch.Tensor, c_wire: torch.Tensor) -> None:
        bc = self.config.bundling
        ac = self.config.app
        c = self.chunk_count
        if ac.streaming_enabled and ac.streaming_check_every and (c + 1) % ac.streaming_check_every == 0:
            raise NotImplementedError(
                f"chunk {c}: the out-of-core streaming check fires here, and streaming "
                "is not ported yet (set streaming_enabled=False or streaming_check_every=0)"
            )
        if c >= min(self.max_chunks, bc.max_num_images):
            raise ValueError(f"chunk {c} exceeds the keyframe/chunk capacity")
        first_frame = c * self.S
        k_idx = c  # one keyframe per chunk
        t_chunk = time.perf_counter()

        with self.timing.stage("chunk_local"):
            res = chunk_mod.process_chunk(
                d_wire, y_wire, self.cam, self.cache_cam, bc,
                sigma_d=ac.depth_sigma_d, sigma_r=ac.depth_sigma_r, filter_depth=ac.depth_filter,
            )
        self.gn_iters_executed += bc.local_gn_iters * 2  # 2 solve+prune rounds

        with self.timing.stage("graph_step"):
            self.graph, self.ctrl, integrate_mask, stats_in = _graph_step(
                self.graph, self.ctrl, k_idx, res, self._local_traj_dev, self._chunk_valid_dev,
                self._anchor_dev, self.cache_cam, bc, is_first=(k_idx == 0),
            )
        self.num_keyframes = k_idx + 1

        if self.num_keyframes > 1:
            with self.timing.stage("global_solve"):
                self.graph, _, _ = global_graph.global_solve(self.graph, self.cache_cam, bc)
            self.gn_iters_executed += bc.global_gn_iters

        with self.timing.stage("publish"):
            self._publish_trajectory()

        lo = 0 if c == 0 else 1  # the overlap frame is already integrated
        dev = self.device
        new_ids = torch.arange(first_frame, first_frame + self.chunk_frames, device=dev)
        new_valid = torch.arange(self.chunk_frames, device=dev) >= lo
        self.num_frames = max(self.num_frames, first_frame + self.chunk_frames)
        with self.timing.stage("plan_fuse"):
            _plan_and_fuse(
                self, c, stats_in, d_wire, c_wire, new_ids, new_valid, integrate_mask,
                exclude_from=first_frame + lo, budget=ac.max_reintegrations_per_frame * self.S,
            )

        if ac.gc_every_chunks and (c + 1) % ac.gc_every_chunks == 0:
            with self.timing.stage("gc"):
                self.table, freed = blocks.garbage_collect(self.table)
                self._gc_freed_total = self._gc_freed_total + freed.to(torch.float32)

        self.timing.record("whole_chunk_step", time.perf_counter() - t_chunk)
        self.chunk_count += 1

    def _publish_trajectory(self) -> None:
        if self.chunk_count == 0 and self.num_keyframes == 0:
            return
        self.traj = _publish_all(
            self.traj, self._local_traj_dev, self._chunk_valid_dev, self.graph.poses, self.graph.valid,
            self.S, self.chunk_frames,
        )

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
        r_cap = self.history_cap
        dev = self.device
        cf, h, w = self.chunk_frames, self.cam.height, self.cam.width
        empty_d = torch.zeros((cf, h, w), dtype=torch.int16, device=dev)
        empty_c = torch.zeros((cf, h // 2, w // 2, 3), dtype=torch.uint8, device=dev)
        empty_ids = torch.zeros(cf, dtype=torch.int64, device=dev)
        empty_valid = torch.zeros(cf, dtype=torch.bool, device=dev)
        no_integrate = torch.zeros((), dtype=torch.bool, device=dev)
        total = 0
        for _ in range(rounds):
            plan = trajectory.plan_reintegration(
                self.traj, budget, rot_thresh=ac.reint_rot_thresh, trans_thresh=ac.reint_trans_thresh,
                exclude_from=self.num_frames,
            )
            frames_np = plan.frames.cpu().numpy()
            work = (plan.deint_mask | plan.reint_mask).cpu().numpy()
            if not work.any():
                break
            ring_np = self._ring_frame.cpu().numpy()
            # at most one frame per ring slot per round (plan order = priority)
            chosen: dict[int, int] = {}
            for f in frames_np[work].tolist():
                chosen.setdefault(f % r_cap, f)
            ups = [f for s, f in chosen.items() if ring_np[s] != f]
            if ups:
                sl = torch.as_tensor([f % r_cap for f in ups], device=dev)
                d = np.stack([self._frame_store[f][0] for f in ups]).view(np.int16)
                self._hist_d16[sl] = torch.as_tensor(d, device=dev)
                self._hist_c8[sl] = torch.as_tensor(np.stack([self._frame_store[f][1] for f in ups]), device=dev)
                self._ring_frame[sl] = torch.as_tensor(ups, dtype=torch.int32, device=dev)
                self._ring_uploads += len(ups)
            _plan_and_fuse(
                self, self.max_chunks, torch.zeros(9, device=dev), empty_d, empty_c, empty_ids, empty_valid,
                no_integrate, exclude_from=self.num_frames, budget=budget,
            )
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

    def finalize(self) -> None:
        """End-of-sequence recovery (idempotent): drain the re-integration
        backlog including ring-spilled frames, then emit the runlog. The first
        device reads of a run happen here."""
        if self._finalized:
            return
        self._finalized = True
        if self.num_keyframes > 1 and int(self.ctrl.reloc_events) > 0:
            raise NotImplementedError(
                "a relocalization happened: revalidating stale keyframes (_revalidate_stale) "
                "is not ported yet"
            )
        self._service_reintegration()
        self._emit_runlog()

    def _emit_runlog(self) -> None:
        rows = self._runlog_dev[: self.chunk_count].cpu().numpy()
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
        return bool(self.ctrl.tracking_lost)

    @property
    def lost_chunks(self) -> int:
        return int(self.ctrl.lost_chunks)

    def current_poses(self) -> tuple[np.ndarray, np.ndarray]:
        n = self.num_frames
        return self.traj.opt_pose[:n].cpu().numpy(), self.traj.opt_valid[:n].cpu().numpy()

    def outputs(self) -> PipelineOutputs:
        self.finalize()
        poses, valid = self.current_poses()
        return PipelineOutputs(
            poses=poses, valid=valid, num_keyframes=self.num_keyframes,
            tracking_lost_chunks=int(self.ctrl.lost_chunks),
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
