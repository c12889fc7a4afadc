"""The online BundleFusion pipeline's serial driver: chunks -> keyframes ->
global BA -> TSDF (port of ``bundlefusion_tpu.bundle.pipeline``).

Between ``push_frame`` and ``flush()`` the host never reads device data, as
in the JAX package: the ingest (``bundle/ingest.py``) converts, stages and
uploads each chunk and hands it to :meth:`BundleFusion._process_chunk`,
which copies it into the static wire and runs the chunk step
(``bundle/step.py``). Three places read device state on the host by
design: the out-of-core streaming check (every ``streaming_check_every``
chunks until streaming engages, then every chunk), the optional periodic
revalidation after a relocalization (``revalidate_every_chunks``), and
``finalize()``, which also places each chunk's device stamps on the host
clock and emits them with its host spans in the runlog records
(``utils/timeline.py``).

A ``mesh`` (``parallel.mesh.make_mesh``) shards the global BA
(``global_graph.global_solve_sharded``): through the ``global_solve``
program when every shard lives on the pipeline's device, eagerly when the
mesh spans several devices (decided at construction, reported in
``graph_stats``).
"""

from __future__ import annotations

import contextlib
import functools
import time
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..fusion import blocks, marching_cubes, raycast, streaming
from ..geometry import se3
from ..geometry.camera import CameraModel
from ..utils.logging import RunLog
from ..utils import graphs, timeline
from ..utils.tensor_ops import copy_into
from ..utils.timing import TimingLog
from . import global_graph, step as step_mod, trajectory
from .ingest import Ingest
from .step import DENSE_FIELDS, PCG_FIELDS, RUNREC_FIELDS, ChunkStep, FusionState, StepInputs

# the TSDF maintenance of the plan_fuse stage and of finalize's service,
# looked up in this module at every call, so that a fault planted on it
# (benchmark/tests/test_bench_newcell.py) reaches both
_plan_and_fuse = step_mod.plan_and_fuse


def _fuse(*args) -> None:
    _plan_and_fuse(*args)


@contextlib.contextmanager
def _chunk_stage(timing: TimingLog, host: timeline.HostSpans, profile: bool, name: str, c: int):
    """Stage ``name`` of chunk ``c`` on the host: a ``TimingLog`` stage (timed
    on the host with ``profile``, else from its stamps at finalize()), whose
    enqueue is chunk ``c``'s host span ``name``."""
    t0 = time.perf_counter()
    with timing.stage(name, block=profile, record=profile):
        yield
    host.interval(c, name, t0, time.perf_counter())


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
        if cam.width % 2 or cam.height % 2 or self.int_cam.width % 2 or self.int_cam.height % 2:
            raise ValueError("frame dimensions must be even (half-res color wire)")
        self.S = bc.submap_size
        self.chunk_frames = bc.chunk_size
        self.max_chunks = bc.max_frames // self.S
        dev = self.device

        self.num_frames = 0
        self.num_keyframes = 0
        self.chunk_count = 0
        self.gn_iters_executed = 0  # host GN iterations (the device counts blocks updated)
        self.anchor = np.eye(4, dtype=np.float32) if anchor_pose is None else anchor_pose
        self._ring_uploads = 0
        self._finalized = False
        self._reloc_seen = 0  # relocalizations already followed by a revalidation
        # out-of-core streaming: cold blocks live in the host store; the
        # occupancy check reads device state, so it runs every
        # streaming_check_every chunks until streaming engages, then every chunk
        self.block_store = streaming.HostBlockStore(chunk_blocks=ac.streaming_chunk_blocks)
        self._streaming_on = False
        # the per-chunk timeline: device stamps in the state, host spans here,
        # joined into the runlog at finalize() (the stamps also into the TimingLog)
        self.timing = TimingLog(dev)
        self._host = timeline.HostSpans()
        self.runlog = RunLog(log_path)
        span = functools.partial(_chunk_stage, self.timing, self._host, profile)

        # the chunk step on an executable of this configuration (the ring
        # holds half-res colour, the v2 wire); a mesh over several devices
        # keeps its sharded solve out of the graphs (decided here, once)
        self._exe = exe = self._checkout_executable()
        self.state: FusionState = exe.state.fusion
        st, inputs = self.state, exe.state.step
        stamps = timeline.Stamps(st.stamps, inputs.chunk)
        route = step_mod.solve_route(mesh, dev)
        self._step = ChunkStep(
            exe, self.config, cam, self.int_cam,
            solve=(step_mod.global_solve_step, st, inputs, self.cache_cam, bc, stamps) if mesh is None
            else (global_graph.global_solve_sharded, st.graph, mesh, self.cache_cam, bc),
            route=graphs.route_for(dev), routes={"global_solve": route} if route else {}, stamps=stamps,
            span=span, fuse=_fuse)
        self._ingest = Ingest(cam, self.int_cam, self.config, dev, exe.stream, st.stamps, self._host, span, profile)
        # its counters: each chunk's upload bytes, the host waits that blocked by site
        self.upload_bytes: list[int] = self._ingest.upload_bytes
        self.ingest_waits = self._ingest.waits

    def _checkout_executable(self) -> graphs.Executable:
        """An idle executable of this configuration, device, camera and mesh
        from the process-wide cache (``step.checkout_step``), or a new one."""
        dev = self.device
        cf, h, w, hi, wi = self.chunk_frames, self.cam.height, self.cam.width, self.int_cam.height, self.int_cam.width

        def fresh():
            return step_mod.make_fusion_state(self.config, self.int_cam, (hi // 2, wi // 2), self.anchor, dev)

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
        return step_mod.checkout_step(self, key, dev, fresh, self.anchor, wire, self.S, cf)

    @property
    def graph_stats(self) -> dict[str, dict]:
        """Per stage of the chunk step (after this pipeline ran it once):
        ``graph`` (captured), ``replays`` by this pipeline, ``captured``
        (by this pipeline), ``capture_s`` and ``route`` ("graph", or why the
        stage runs eagerly)."""
        return self._step.stats()

    def push_frame(self, depth: np.ndarray, color: np.ndarray) -> None:
        """Feed one frame; chunks are processed as soon as complete. Frames
        convert to the wire format on the host (uint16 mm depth, uint8 luma,
        half-res uint8 colour; with ``integrate_filtered_depth`` the depth is
        bilateral-filtered there, so the ring, the FrameStore and every
        device program see the same bytes; with a separate integration
        resolution, depth and colour are also decimated for fusion) and
        upload once per chunk. The time busy here, waits and (without the
        ingest workers) the chunk step left out, is the chunk's ``ingest_s``
        in its timeline, and the entry of its last frame its ``pushed``."""
        self._ingest.push(depth, color, self._process_chunk)

    def push_batch(self, depth: np.ndarray, color: np.ndarray, valid=None) -> None:
        for i in range(depth.shape[0]):
            if valid is None or valid[i]:
                self.push_frame(depth[i], color[i])

    def _device_ctx(self):
        """The pipeline's device and compute stream (the executable's: every
        chunk's work is enqueued on it, from any thread) for the calling thread."""
        return graphs.stream_ctx(self.device, self._exe.stream)

    def _process_chunk(self, d_wire: torch.Tensor, y_wire: torch.Tensor, c_wire: torch.Tensor,
                       d_wire_int: torch.Tensor, c_wire_int: torch.Tensor, c: int) -> None:
        """Chunk ``c``, uploaded (the ingest's dispatch callback, on the
        compute stream): its wire into the static buffers, the chunk step
        (``step.ChunkStep``), then the host's own work: streaming and the
        periodic revalidation."""
        bc = self.config.bundling
        ac = self.config.app
        if c >= min(self.max_chunks, bc.max_num_images):
            raise ValueError(f"chunk {c} exceeds the keyframe/chunk capacity")
        t_chunk = time.perf_counter()
        # the chunk's wire into the static buffers (the last two alias the
        # first and third at one resolution); the step inputs are set from
        # the host only when they do not hold chunk c (a restored pipeline)
        with self._host.span(c, "wire"):
            copied: set[int] = set()
            for dst, src in zip(self._exe.state.wire, (d_wire, y_wire, c_wire, d_wire_int, c_wire_int)):
                if id(dst) not in copied:
                    dst.copy_(src)
                    copied.add(id(dst))
            self._step.seek(c)
        self._host.put(c, "graph_slots", self._step(c))
        self.num_keyframes = c + 1  # one keyframe per chunk
        self.num_frames = max(self.num_frames, c * self.S + self.chunk_frames)
        # 2 local solve+prune rounds, and the global solve after chunk 0
        self.gn_iters_executed += bc.local_gn_iters * 2 + (bc.global_gn_iters if c else 0)

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

        self.timing.record("whole_chunk_step", time.perf_counter() - t_chunk)
        self.chunk_count = c + 1

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

    def _post_revalidate_solve(self) -> None:
        """Global BA of the keyframe graph (sharded over the mesh when there
        is one), then the trajectory."""
        bc = self.config.bundling
        if self.num_keyframes > 1 and self.mesh is not None:
            global_graph.global_solve_sharded(self.state.graph, self.mesh, self.cache_cam, bc)
        elif self.num_keyframes > 1:
            global_graph.global_solve(self.state.graph, self.cache_cam, bc)
        self._publish_trajectory()

    def _publish_trajectory(self) -> None:
        if self.chunk_count == 0 and self.num_keyframes == 0:
            return
        step_mod.publish_all(self.state, self.S, self.chunk_frames)

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
                d = np.stack([self._ingest.frame_store[f][0] for f in ups]).view(np.int16)
                st.hist_d16[sl] = torch.as_tensor(d, device=dev)
                st.hist_c8[sl] = torch.as_tensor(np.stack([self._ingest.frame_store[f][1] for f in ups]), device=dev)
                st.ring_frame[sl] = torch.as_tensor(ups, dtype=torch.int32, device=dev)
                self._ring_uploads += len(ups)
            _plan_and_fuse(st, ac, self.int_cam, service, torch.zeros(9, device=dev), empty_d, empty_c, no_integrate,
                           budget)
            total += len(chosen)
        return total

    def flush(self) -> None:
        """Process tail frames as a final chunk by repeating the last frame to
        fill it, then :meth:`sync`."""
        self._ingest.flush(self._process_chunk)
        self.sync()

    def sync(self) -> None:
        """Drain the ingest workers: wait until every staged chunk has been
        uploaded and dispatched (its device work may still be in flight;
        reads of its results wait for it). Pipeline state is coherent on the
        caller's thread only after this returns; every public accessor calls
        it first. Exceptions raised on the workers re-raise here in chunk
        order (an upload's through its chunk's dispatch). The caller's
        current stream then waits for the pipeline's stream."""
        self._ingest.sync()

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
        self._ingest.bp_events.clear()
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
        """The runlog's per-chunk records, read from the device once. Each
        chunk this pipeline ran gets its ``timeline`` (the device stamps
        placed on the host clock here, with its host spans), and, unless
        ``profile`` timed the stages on the host, its stamped stages' device
        times go to the TimingLog."""
        rows = self.state.runlog_rows[: self.chunk_count].cpu().numpy()
        dense = self.state.dense_counts[: self.chunk_count].cpu().numpy()
        pcg = self.state.pcg_counts[: self.chunk_count].cpu().numpy()
        stamps = self.state.stamps[: self.chunk_count].cpu().numpy()
        offset_ns, err_ns = timeline.calibrate(self.device)
        flags = ("chunk_valid", "kf_valid", "reloc", "tracking_lost")  # the other fields are counts
        for c in range(rows.shape[0]):
            rec = {k: bool(v) if k in flags else int(v) for k, v in zip(RUNREC_FIELDS, rows[c])}
            rec.update({k: int(v) for k, v in zip(DENSE_FIELDS, dense[c])})
            rec.update({k: int(v) for k, v in zip(PCG_FIELDS, pcg[c])})
            if c in self._host.by_chunk:  # a chunk this pipeline ran (not one restored)
                rec["timeline"] = timeline.chunk_record(stamps[c], self._host.by_chunk[c], offset_ns, err_ns)
                for span, (b, e) in rec["timeline"]["device"].items():
                    if span not in timeline.CHILDREN and not self.profile:
                        self.timing.record(span, e - b)
            self.runlog.log(chunk=c, **rec)
        if self._ring_uploads:
            self.runlog.log(ring_uploads=self._ring_uploads)

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
