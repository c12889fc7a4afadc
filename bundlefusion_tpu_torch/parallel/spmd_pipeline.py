"""End-to-end multi-sequence pipeline over a mesh
(port of ``bundlefusion_tpu.parallel.spmd_pipeline``).

:func:`run_sequences_sharded` replays D sequences over a D-shard mesh in
lockstep: each chunk round runs, for every shard on its own device, the
same stages as the serial pipeline (``bundle/pipeline.py``) — the chunk
program (preprocess with K2, SIFT, matching, filters, local BA), the
keyframe-graph step (add, match, relocalize, the tracking-lost state
machine), global BA, trajectory publish, the plan + ring + de/re-integrate
TSDF step (K1) and the periodic GC — on that shard's sequence, with no
traffic between shards.

Execution, as in the JAX package, where each stage is one
``jax.jit(shard_map(...))`` program per chunk round: every shard checks out
an executable of its own (``utils/graphs.py``; a cache of this module's,
keyed by configuration, device, camera and the v1 wire) that holds the
shard's ``FusionState``, persistent step inputs that the ``plan_fuse``
stage advances on the device, the graph step's carry and static wire
buffers (depth [cf, H, W] int16, colour [cf, H, W, 3] uint8). Its stages
are the serial pipeline's programs (``chunk_local``, ``graph_step_first``,
``graph_step@T`` for each slot tier T, ``global_solve``, ``publish``,
``plan_fuse``, ``gc``): on a card each is captured as a CUDA graph at its
first call and replayed after (the graph step's tiers all at round 1), on
the shard's own stream, so two shards on one card may overlap. A run
built under ``graphs.disable_graphs()`` runs them eagerly on the card; on
the CPU they call their functions. Each shard uploads its chunk from a warm
pinned 3-deep rotation straight into its static wire, after waiting on the
event recorded behind the buffer's last copy (a host wait, no readback).

Frames travel as the v1 wire (``framewire.frame_to_wire``: uint16 mm depth
and full-resolution uint8 RGB), so the chunk program takes its RGB branch
and the frame ring holds full-resolution colour [R, H, W, 3]; with
``integrate_filtered_depth`` the wire depth is filtered first, as in the
serial pipeline.

The driver reads nothing back until the final fetch: chunk validity,
relocalization, re-integration plans and diagnostics stay on the devices.

Not supported in the sharded driver (as in the JAX package): out-of-core
streaming, stale-keyframe revalidation and the finalize-time ring-spill
service; run those through the serial pipeline. The driver integrates at
the input resolution whatever the configuration's integration resolution,
as the JAX package's does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..bundle import global_graph
from ..bundle.pipeline import (
    _STAGING_DEPTH,
    FusionState,
    _chunk_local,
    _gc,
    _plan_fuse_step,
    _publish_all,
    _staging_checkout,
    checkout_step,
    make_fusion_state,
    run_graph_step,
    stream_ctx,
)
from ..config import Config
from ..fusion import blocks, marching_cubes
from ..geometry.camera import CameraModel
from ..io import framewire
from ..utils import graphs
from .mesh import Mesh

# the shards' executables by (configuration, device, camera, wire): the v1
# wire and its full-resolution colour ring make them another step than the
# serial pipeline's
_EXECUTABLES = graphs.ExecutableCache()


class ShardedOutputs(NamedTuple):
    poses: np.ndarray  # [D, F, 4, 4]
    valid: np.ndarray  # [D, F]
    num_keyframes: int
    tables: list[blocks.BlockTable]  # table i on shard i's device (the shard executable's own: see ShardedRun)
    runlogs: np.ndarray  # [D, C, RUNREC_WIDTH] per-sequence diagnostics rows


class _Tables(list):
    """The shards' block tables, which live in their executables' state:
    the executables return to the cache only when the run and every holder
    of this list are gone, so that a later run cannot reset tables a caller
    still reads."""


class ShardedRun:
    """The state and steps of :func:`run_sequences_sharded`: set up on
    construction (wire conversion of every frame, one executable per shard),
    :meth:`step` runs one chunk round over every shard, :meth:`outputs`
    fetches the results (the run's first device reads)."""

    def __init__(self, sequences, mesh: Mesh, config: Config | None = None, anchor_poses: np.ndarray | None = None):
        cfg = config or Config()
        cfg.validate()
        bc, ac = cfg.bundling, cfg.app
        d = mesh.size
        if len(sequences) != d:
            raise ValueError(f"need {d} sequences for a {d}-shard mesh, got {len(sequences)}")
        cam: CameraModel = sequences[0].camera
        if any(s.camera != cam for s in sequences):
            raise ValueError("sequences must share intrinsics")
        self.mesh, self.config, self.cam = mesh, cfg, cam
        self.cache_cam = cam.scaled(bc.cache_width, bc.cache_height)
        n_frames = min(s.depth.shape[0] for s in sequences)
        self.n_chunks = max(0, (n_frames - 1) // bc.submap_size)
        if self.n_chunks > min(bc.max_frames // bc.submap_size, bc.max_num_images):
            raise ValueError(f"{self.n_chunks} chunks exceed the keyframe/chunk capacity")
        anchors = np.broadcast_to(np.eye(4, dtype=np.float32), (d, 4, 4)) if anchor_poses is None else anchor_poses

        def to_wire(seq, f):
            d16, c8 = framewire.frame_to_wire(seq.depth[f], seq.color[f])
            if ac.integrate_filtered_depth:
                d16 = framewire.bilateral_wire(d16, ac.depth_sigma_d, ac.depth_sigma_r)
            return d16, c8

        self.wires = []  # per shard: (depth [F, H, W] uint16, colour [F, H, W, 3] uint8)
        for s in sequences:
            frames = [to_wire(s, f) for f in range(n_frames)]
            self.wires.append((np.stack([x for x, _ in frames]), np.stack([y for _, y in frames])))

        # one executable per shard: the ring holds full-resolution colour (v1 wire)
        cf, h, w = bc.chunk_size, cam.height, cam.width
        self.tables = _Tables()
        self.exes: list[graphs.Executable] = []
        self._routes = [graphs.route_for(dev) for dev in mesh.devices]
        for i, dev in enumerate(mesh.devices):
            def fresh(i=i, dev=dev):
                return make_fusion_state(cfg, cam, (h, w), anchors[i], dev)

            def wire(dev=dev):
                return (torch.zeros((cf, h, w), dtype=torch.int16, device=dev),
                        torch.zeros((cf, h, w, 3), dtype=torch.uint8, device=dev))

            key = (cfg.to_json(), str(dev), tuple(cam), "v1 wire")
            exe = checkout_step(_EXECUTABLES, self.tables, key, dev, fresh, anchors[i], wire, bc.submap_size, cf)
            self.exes.append(exe)
            self.tables.append(self.exes[-1].state.fusion.table)
        self.shards: list[FusionState] = [exe.state.fusion for exe in self.exes]
        self._counters_at_start = [exe.counters() for exe in self.exes]
        # per shard, a warm 3-deep rotation of host buffers (pinned on a card)
        spec = (((cf, h, w), np.uint16), ((cf, h, w, 3), np.uint8))
        self._staging = [_staging_checkout(self, spec, pinned=dev.type == "cuda") for dev in mesh.devices]
        self._next_round = 0

    @property
    def graph_stats(self) -> list[dict[str, dict]]:
        """Per shard, per stage (after this run ran it once): ``graph``
        (captured), ``replays`` by this run, ``captured`` (by this run),
        ``capture_s`` and ``route`` ("graph", or why it runs eagerly)."""
        return [exe.stats(start, lambda name, r=route: r)
                for exe, start, route in zip(self.exes, self._counters_at_start, self._routes)]

    def step(self, c: int) -> None:
        """Chunk round ``c`` (rounds run in order from 0): every shard
        consumes frames [c*S, c*S + S], on its own stream."""
        if c != self._next_round:
            raise ValueError(f"chunk round {c} out of order: the shards' step inputs hold round {self._next_round}")
        bc = self.config.bundling
        first, cf = c * bc.submap_size, bc.chunk_size
        for i, (d16, c8) in enumerate(self.wires):
            exe = self.exes[i]
            with stream_ctx(exe.device, exe.stream):
                self._upload(i, c, d16[first : first + cf], c8[first : first + cf])
                self._shard_chunk(i, c)
        self._next_round += 1

    def _upload(self, i: int, c: int, d16: np.ndarray, c8: np.ndarray) -> None:
        """Shard ``i``'s chunk into its static wire: one warm host buffer of
        the rotation, refilled once its last copy is done, then two copies
        (non-blocking from pinned memory on a card) in the shard's stream
        order."""
        buf = self._staging[i][c % _STAGING_DEPTH]
        if buf.copied is not None:
            buf.copied.synchronize()  # an event of the shard's stream: no data comes back
        buf.arrays[0][:] = d16
        buf.arrays[1][:] = c8
        dw, cw = self.exes[i].state.wire
        n1 = d16.nbytes
        dw.copy_(buf.flat[:n1].view(torch.int16).view(dw.shape), non_blocking=True)
        cw.copy_(buf.flat[n1:].view(cw.shape), non_blocking=True)
        if self.exes[i].stream is not None:
            buf.copied = torch.cuda.Event()
            buf.copied.record()

    def _shard_chunk(self, i: int, c: int) -> None:
        """Shard ``i``'s chunk step: the serial pipeline's stages, each
        through the shard executable's program of its name."""
        bc, ac = self.config.bundling, self.config.app
        exe, graphed = self.exes[i], self._routes[i] == "graph"
        st, step, wire, carry = exe.state.fusion, exe.state.step, exe.state.wire, exe.state.carry
        S, cf = bc.submap_size, bc.chunk_size

        def run(name, fn, *args):
            return exe.program(name, fn)(*args, graphed=graphed)

        res = run("chunk_local", _chunk_local, wire, self.cam, self.cache_cam, bc, ac)
        first = c == 0
        run_graph_step(exe, lambda fn: fn, c, bc.max_num_images, (st, step, res, self.cache_cam, bc, first, carry),
                       graphed)
        if not first:
            run("global_solve", global_graph.global_solve, st.graph, self.cache_cam, bc)
        run("publish", _publish_all, st, S, cf)
        # a fixed new-frame width: the overlap frame (already integrated) is
        # a masked row after chunk 0
        run("plan_fuse", _plan_fuse_step, st, ac, self.cam, step, carry, wire[0], wire[1],
            ac.max_reintegrations_per_frame * S, S)
        if ac.gc_every_chunks and (c + 1) % ac.gc_every_chunks == 0:
            run("gc", _gc, st)

    def outputs(self) -> ShardedOutputs:
        """The run's first device reads: poses, validity and runlogs, each
        stacked on shard 0's device and fetched once, after the caller's
        stream on each device has waited for the shards' streams."""
        S = self.config.bundling.submap_size
        n_out = self.n_chunks * S + 1 if self.n_chunks else 0
        dev0 = self.mesh.devices[0]
        for exe in self.exes:
            if exe.stream is not None:
                torch.cuda.current_stream(exe.device).wait_stream(exe.stream)

        def fetch(get):
            return torch.stack([get(sh).to(dev0) for sh in self.shards]).cpu().numpy()

        return ShardedOutputs(
            poses=fetch(lambda sh: sh.traj.opt_pose[:n_out]),
            valid=fetch(lambda sh: sh.traj.opt_valid[:n_out]),
            num_keyframes=self.n_chunks,
            tables=self.tables,
            runlogs=fetch(lambda sh: sh.runlog_rows[: self.n_chunks]),
        )


def run_sequences_sharded(
    sequences,  # D sequences (depth [F, H, W], color [F, H, W, 3], camera), one per shard
    mesh: Mesh,
    config: Config | None = None,
    anchor_poses: np.ndarray | None = None,  # [D, 4, 4]
) -> ShardedOutputs:
    run = ShardedRun(sequences, mesh, config, anchor_poses)
    for c in range(run.n_chunks):
        run.step(c)
    return run.outputs()


def extract_mesh_for(outputs: ShardedOutputs, seq_idx: int, cfg: Config):
    """Mesh one sequence's reconstruction."""
    return marching_cubes.extract_mesh(outputs.tables[seq_idx], cfg.app)
